"""The benchmark's device table, the compile-cache location and the
conformance gate's device route."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import bench  # noqa: E402


class TestBandwidthTable:
    @pytest.mark.parametrize(
        "kind", ["cpu", "Quadro RTX 6000", "NVIDIA A100-SXM4-80GB", ""]
    )
    def test_unknown_device_kind_raises(self, kind):
        with pytest.raises(ValueError, match="no published memory"):
            bench.hbm_bytes_per_s(kind)

    def test_h100(self):
        assert bench.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12

    def test_bench_refuses_cpu_before_allocating(self):
        with pytest.raises(ValueError, match="'cpu'"):
            bench.main()


@pytest.fixture
def cache_calls(monkeypatch):
    """Record jit_cache's jax.config updates instead of applying them."""
    import jax

    from monkey_moore_tpu.utils import jit_cache

    calls = []
    monkeypatch.setattr(jit_cache, "_done", False)
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.append((k, v))
    )
    monkeypatch.delenv("MMTPU_NO_JIT_CACHE", raising=False)
    return jit_cache, calls


class TestJitCache:
    def test_env_dir_is_used(self, cache_calls, monkeypatch, tmp_path):
        jit_cache, calls = cache_calls
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        jit_cache.enable_persistent_cache()
        assert ("jax_compilation_cache_dir", str(tmp_path / "c")) in calls
        dirs = [v for k, v in calls if k == "jax_compilation_cache_dir"]
        assert dirs == [str(tmp_path / "c")]

    def test_default_dir_inside_checkout(self, cache_calls, monkeypatch):
        jit_cache, calls = cache_calls
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert jit_cache.cache_dir() == REPO / ".jax_cache"
        jit_cache.enable_persistent_cache()
        assert ("jax_compilation_cache_dir", str(REPO / ".jax_cache")) in calls
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()

    def test_opt_out_and_idempotent(self, cache_calls, monkeypatch):
        jit_cache, calls = cache_calls
        monkeypatch.setenv("MMTPU_NO_JIT_CACHE", "1")
        jit_cache.enable_persistent_cache()
        assert calls == []
        monkeypatch.delenv("MMTPU_NO_JIT_CACHE")
        jit_cache.enable_persistent_cache()  # already decided: no-op
        assert calls == []

    def test_engine_device_route_enables_cache(
        self, cache_calls, tmp_path
    ):
        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine

        jit_cache, calls = cache_calls
        p = tmp_path / "f.bin"
        p.write_bytes(bytes(range(256)) * 8)
        SearchEngine(SearchConfig(
            file_path=p, keyword="abcde", host_latency_threshold_bytes=0
        )).run()
        assert jit_cache._done
        assert any(k == "jax_compilation_cache_dir" for k, _ in calls)


def test_conformance_gate_device_route():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "conformance_gate", REPO / "tools" / "conformance_gate.py"
    )
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    assert gate.main(["--trials", "4", "--multi-trials", "1",
                      "--device-route", "--seed", "11"]) == 0
