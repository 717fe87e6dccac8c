#!/usr/bin/env python
"""Full benchmark matrix mirroring the reference's suites
(``benchmarks/bench_search.cpp:67-104``): 8/16-bit relative search and
wildcard Front/Middle/Back variants, bytes/s on device-resident data.

Every suite runs the PRODUCTION pipelined path on a resident corpus
generated on the device (threefry, fixed seed) as one flat element array
under the scan's ``2**31``-element limit, with ``--pipeline`` fused steps
kept in flight exactly like ``bench.py`` and the engine's chunk loop
(``SearchConfig.pipeline_depth``).  Each suite records the sync and
pipelined rates plus its ``pct_hbm_roofline`` against the device's
published bandwidth (``bench.HBM_BYTES_PER_S``; an unknown device is an
error).

Writes ``out/BENCH_DETAIL.json`` (``-o`` to change) and prints a table.

Usage: python tools/bench_all.py [--mb 1024] [--iters 10]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SUITES = [
    ("BM_Search/Relative/8-Bit", "abcde", 0, 1),
    ("BM_Search/Relative/16-Bit", "abcde", 0, 2),
    ("BM_Search/Relative/Wildcard/Front/8-Bit", "*bcde", "*", 1),
    ("BM_Search/Relative/Wildcard/Middle/8-Bit", "ab*de", "*", 1),
    ("BM_Search/Relative/Wildcard/Back/8-Bit", "abcd*", "*", 1),
    ("BM_Search/Relative/Wildcard/Front/16-Bit", "*bcde", "*", 2),
    ("BM_Search/Relative/Wildcard/Middle/16-Bit", "ab*de", "*", 2),
    ("BM_Search/Relative/Wildcard/Back/16-Bit", "abcd*", "*", 2),
]


def device_corpus(jax, jnp, n_elems, dtype, pad_elems):
    """Random flat corpus generated on the device (threefry, fixed seed)
    plus ``pad_elems`` zero halo elements."""

    @jax.jit
    def make(key):
        body = jax.random.bits(key, (n_elems,), dtype=dtype)
        return jnp.concatenate([body, jnp.zeros(pad_elems, dtype)])

    return jax.block_until_ready(make(jax.random.PRNGKey(42)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=1024,
                    help="per-suite resident corpus size in MiB (one flat "
                         "array, < 2**31 elements)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--pipeline", type=int, default=3,
                    help="fused steps kept in flight (bench.py's depth)")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the 128 KiB..16 MiB buffer-size ladder")
    ap.add_argument("--sweep-only", action="store_true",
                    help="re-run ONLY the host-path sweep and merge into "
                         "the existing output (the sweep never touches the "
                         "device, so this is safe to rerun without "
                         "disturbing recorded suite numbers)")
    ap.add_argument("-o", "--output", type=Path,
                    default=REPO / "out" / "BENCH_DETAIL.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from monkey_moore_tpu.dense import (
        MAX_DEVICE_ELEMS,
        TILE_ELEMS,
        fused_count_extract,
        fused_count_extract_finish,
        fused_count_extract_start,
    )
    from monkey_moore_tpu.pattern import compile_pattern
    from monkey_moore_tpu.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()

    from bench import card_line, hbm_bytes_per_s  # shared bandwidth table

    # device queries only when the suites run — the host-only sweep
    # refresh (--sweep-only) must not initialize the backend at all
    peak = None
    if not args.sweep_only:
        dev0 = jax.devices()[0]
        peak = hbm_bytes_per_s(dev0.device_kind)
        print(f"device: {dev0.platform} {dev0.device_kind} "
              f"x{len(jax.devices())} | card: {card_line()}", flush=True)

    if args.sweep_only and args.no_sweep:
        print("error: --sweep-only and --no-sweep are contradictory",
              file=sys.stderr)
        return 1
    n_bytes = args.mb * 1024 * 1024
    if n_bytes + TILE_ELEMS >= MAX_DEVICE_ELEMS and not args.sweep_only:
        print(f"error: --mb {args.mb} exceeds one device array "
              "(< 2**31 elements)", file=sys.stderr)
        return 1

    def bench_step(pat, n, width, tile_elems, size_bytes):
        """Build the suite's corpus, return best-of-iters step seconds."""
        dtype = jnp.uint8 if width == 1 else jnp.uint16
        pad = (-(-n // tile_elems) + 1) * tile_elems - n
        dev = device_corpus(jax, jnp, n, dtype, pad)

        def step():
            # k_cap auto-sizes from the pattern's expected prefilter FP
            # rate (wildcard keywords legitimately match random data at
            # ~2^-8c per window — those are true matches, not noise)
            _, _, info = fused_count_extract(
                pat, dev, n, tile_elems=tile_elems
            )
            return info

        info = step()  # compile
        for _ in range(args.warmup):
            step()
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.perf_counter()
            info = step()
            best = min(best, time.perf_counter() - t0)

        # Pipelined steady state — the engine's production loop (deque of
        # ``--pipeline`` in-flight fused steps, every result still fetched
        # D2H, one step late; bench.py's apparatus)
        from collections import deque

        depth = max(1, args.pipeline)
        fallbacks = 0
        pend = deque()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            pend.append(
                fused_count_extract_start(
                    pat, dev, n, tile_elems=tile_elems
                )
            )
            if len(pend) >= depth:
                fin = fused_count_extract_finish(pend.popleft())
                fallbacks += bool(fin[2].fallback)
        while pend:
            fin = fused_count_extract_finish(pend.popleft())
            fallbacks += bool(fin[2].fallback)
        piped = (time.perf_counter() - t0) / args.iters
        del dev, pend
        return best, piped, info, fallbacks

    results = {}
    for name, keyword, wildcard, width in (
        [] if args.sweep_only else SUITES
    ):
        dtype = np.uint8 if width == 1 else np.uint16
        pat = compile_pattern(keyword, wildcard, dtype=dtype)
        n = n_bytes // width
        best, piped, info, fallbacks = bench_step(
            pat, n, width, TILE_ELEMS, n_bytes
        )
        bps = n_bytes / min(best, piped)
        results[name] = {
            "bytes_per_s": bps,
            "sync_bytes_per_s": n_bytes / best,
            "pipelined_bytes_per_s": n_bytes / piped,
            "pipeline_depth": args.pipeline,
            "pct_hbm_roofline": 100.0 * bps / peak,
            "matches_per_step": info.candidates,
            "fused_fallbacks": fallbacks,
        }
        print(
            f"{name:<45} {bps / 1e9:8.2f} GB/s (sync "
            f"{n_bytes / best / 1e9:6.2f} | piped "
            f"{n_bytes / piped / 1e9:6.2f})  "
            f"{results[name]['pct_hbm_roofline']:5.1f}% HBM",
            flush=True,
        )

    # Buffer-size ladder (the reference's Range(128<<10, 16<<20) with
    # RangeMultiplier(4), ``benchmarks/bench_search.cpp:70``).  Measures what
    # the framework actually runs at these sizes — the engine routes them to
    # the HOST latency path (config.host_latency_threshold_bytes), so the
    # sweep times (a) the full engine end-to-end on a real file and (b) the
    # core-level in-memory scan, the exact apparatus level of the
    # reference's own benchmark (``bench_search.cpp:30-37`` times
    # ``MonkeyMoore::search`` over an in-memory buffer).
    sweep = {}
    sweep_detail = {}
    if not args.no_sweep:
        import tempfile

        from monkey_moore_tpu.config import SearchConfig
        from monkey_moore_tpu.engine import SearchEngine
        from monkey_moore_tpu.ops.scan_host import host_candidates_values

        pat = compile_pattern("abcde")
        rng = np.random.default_rng(42)
        print()
        for size in [128 << 10 << (2 * i) for i in range(4)] + [16 << 20]:
            buf = rng.integers(0, 256, size, dtype=np.uint8)
            path = tempfile.mktemp(suffix=".bin")
            buf.tofile(path)
            try:
                eng = SearchEngine(
                    SearchConfig(file_path=path, keyword="abcde")
                )
                eng.run()  # warm: pattern memo + native scanner build
                assert eng.last_stats.host_routed, "sweep must ride host path"
                best = float("inf")
                # sub-millisecond scans need more draws for a stable best
                # (scheduler noise dominates single runs at these sizes)
                for _ in range(max(args.iters, 30 if size < (1 << 20)
                                   else args.iters)):
                    t0 = time.perf_counter()
                    eng.run()
                    best = min(best, time.perf_counter() - t0)
            finally:
                Path(path).unlink(missing_ok=True)
            core_best = float("inf")
            for _ in range(args.iters):
                t0 = time.perf_counter()
                host_candidates_values(pat, buf)
                core_best = min(core_best, time.perf_counter() - t0)
            sweep[str(size)] = size / best
            sweep_detail[str(size)] = {
                "engine_end_to_end_bytes_per_s": size / best,
                "core_scan_bytes_per_s": size / core_best,
            }
            print(
                f"sweep {size >> 10:>6} KiB  engine {size / best / 1e9:6.2f}"
                f" GB/s  core {size / core_best / 1e9:6.2f} GB/s",
                flush=True,
            )

    out = args.output
    if args.sweep_only and out.exists():
        # preserve the recorded suite numbers (and device field); refresh
        # only the sweep
        blob = json.loads(out.read_text())
        blob["buffer_size_sweep_8bit"] = sweep
        blob["buffer_size_sweep_8bit_detail"] = sweep_detail
    else:
        blob = {
            "data_mb": args.mb,
            "device": {
                "platform": jax.devices()[0].platform,
                "kind": jax.devices()[0].device_kind,
                "count": len(jax.devices()),
                "card": card_line(),
            },
            "suites": results,
            "buffer_size_sweep_8bit": sweep,
            "buffer_size_sweep_8bit_detail": sweep_detail,
        }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(blob, indent=2))
    print(f"\nwritten: {out}")


if __name__ == "__main__":
    sys.exit(main() or 0)
