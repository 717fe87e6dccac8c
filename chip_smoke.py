#!/usr/bin/env python
"""GPU smoke test: the relative-search engine end to end on an NVIDIA card.

Run from the repository root, as one process that owns the card:

    python chip_smoke.py                # one card (the default)
    python chip_smoke.py --four-cards   # the sharded mesh path on 4 cards

One card: a seeded 737,280,000-byte corpus (an 80-minute CD-ROM image in
Mode 1, 360,000 sectors x 2,048 bytes, ECMA-130 — the disc images PS1-era
translation projects search) with encoded keywords planted near the start,
across the 512 MiB device-chunk seam, across count-tile seams, at odd byte
alignment for 16-bit, and next to EOF.  Every search goes through the
normal entry points with the default ``SearchConfig`` (so the resident
device route runs) and is compared EXACTLY — offsets and equivalency maps —
with the host route on the same file (the C dense scanner,
``native/mm_walker.cpp``); the Python oracle over a window around each
planted match must be a subset of the results.  Then it times the fused
step over one resident 512 MiB chunk beside a plain XLA read of the same
bytes, and runs the conformance gate on the device route.

``--four-cards``: a 1 GiB corpus sharded over four cards
(``SearchEngine(devices=...)``), each search compared exactly with the
one-card result in the same process; nothing else runs.

Exits non-zero without a result line unless JAX runs on a GPU.  The last
line of stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

#: 80-minute CD-ROM, Mode 1: 360,000 sectors x 2,048 user bytes (ECMA-130)
CD_IMAGE_BYTES = 360_000 * 2048
MESH_CORPUS_BYTES = 1 << 30
DEVICE_CHUNK_BYTES = 512 * 1024 * 1024
CONFORMANCE_TRIALS = 40


class SmokeFailure(AssertionError):
    """A check of the smoke test did not hold."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Search specs and the corpus they are planted in


@dataclasses.dataclass(frozen=True)
class Spec:
    """One search: ``SearchConfig`` fields plus the bytes planted for it."""

    name: str
    config: dict
    planted: bytes  #: the keyword encoded as it is planted in the corpus

    @property
    def width(self) -> int:
        return self.config.get("element_width", 1)


def _encode(values, width: int, big: bool = False) -> bytes:
    mod = 1 << (8 * width)
    arr = np.array([int(v) % mod for v in values], dtype=np.int64)
    if width == 1:
        return arr.astype(np.uint8).tobytes()
    return arr.astype(">u2" if big else "<u2").tobytes()


def _ascii(keyword: str, width: int, shift: int, big: bool = False) -> bytes:
    return _encode([ord(c) + shift for c in keyword], width, big)


def one_card_specs():
    """The searches of the one-card run, as ``(specs, multi_specs)``."""
    from monkey_moore_tpu.config import Endianness
    from monkey_moore_tpu.pattern import compile_pattern
    from monkey_moore_tpu.sequences import DEFAULT_KATAKANA

    specs = []
    # the eight reference suites (benchmarks/bench_search.cpp:67-104)
    for width in (1, 2):
        for keyword, wildcard in (("abcde", 0), ("*bcde", "*"),
                                  ("ab*de", "*"), ("abcd*", "*")):
            shift = 3 + len(specs)
            specs.append(Spec(
                f"{8 * width}-bit {keyword}",
                dict(keyword=keyword, wildcard=wildcard,
                     element_width=width),
                _ascii("abcde", width, shift),
            ))
    specs.append(Spec(
        "16-bit big-endian abcde",
        dict(keyword="abcde", element_width=2,
             endianness=Endianness.BIG),
        _ascii("abcde", 2, 300, big=True),
    ))
    specs.append(Spec(
        "16-bit little-endian MonKey (mixed case)",
        dict(keyword="MonKey", element_width=2),
        _encode([ord(c) + (40 if c.islower() else 900) for c in "MonKey"],
                2),
    ))
    specs.append(Spec(
        "8-bit mixed case MonKey",
        dict(keyword="MonKey"),
        _encode([ord(c) + (7 if c.islower() else -20) for c in "MonKey"], 1),
    ))
    values = [60, 61, 62, 63, 64, 71]
    specs.append(Spec(
        "8-bit value scan",
        dict(is_relative_search=False, reference_values=values),
        _encode([v + 30 for v in values], 1),
    ))
    kana = compile_pattern("サムライ", 0, DEFAULT_KATAKANA)
    specs.append(Spec(
        "8-bit katakana sequence サムライ",
        dict(keyword="サムライ", custom_char_seq=DEFAULT_KATAKANA),
        _encode([kana.char_index[ord(c)] + 0x40 for c in "サムライ"], 1),
    ))
    multi = [
        Spec(f"multi {kw}", dict(keyword=kw), _ascii(kw, 1, 11 + i))
        for i, kw in enumerate(("sword", "shield", "potion", "ether",
                                "elixir", "phoenix", "tent", "hammer"))
    ]
    return specs, multi


def mesh_specs():
    """The searches of the four-card run (``BASELINE.json`` config 5: a
    custom-sequence search over a 1 GB corpus, plus 8-bit plain and 16-bit
    big-endian)."""
    from monkey_moore_tpu.config import Endianness
    from monkey_moore_tpu.pattern import compile_pattern
    from monkey_moore_tpu.sequences import DEFAULT_KATAKANA

    kana = compile_pattern("サムライ", 0, DEFAULT_KATAKANA)
    return [
        Spec("8-bit katakana sequence サムライ",
             dict(keyword="サムライ", custom_char_seq=DEFAULT_KATAKANA),
             _encode([kana.char_index[ord(c)] + 0x40 for c in "サムライ"],
                     1)),
        Spec("8-bit abcde", dict(keyword="abcde"), _ascii("abcde", 1, 5)),
        Spec("16-bit big-endian abcde",
             dict(keyword="abcde", element_width=2,
                  endianness=Endianness.BIG),
             _ascii("abcde", 2, 300, big=True)),
    ]


def plan_plants(specs, size: int, chunk_bytes: int, tile_elems: int):
    """Byte offsets to plant each spec at: ``{spec name: [offsets]}``.

    Every spec gets a plant near the start, one straddling a count-tile
    seam (a multiple of ``2 * tile_elems`` bytes, a tile seam of both the
    8- and the 16-bit grid) and one within a window of EOF (the first spec
    at the very last window).  16-bit specs also get an odd-aligned plant.
    The first spec straddles the ``chunk_bytes`` device-chunk seam.
    Raises ``ValueError`` if plants would overlap or leave the file.
    """
    n = len(specs)
    tile_stride = 2 * tile_elems
    region = 4096 + 512 * n + 4096  # tile-seam plants start past this
    # tile seams past the start region that are not device-chunk seams
    seams = (
        t * tile_stride for t in range(-(-region // tile_stride), size)
        if (t * tile_stride) % chunk_bytes
    )
    plan = {}
    for i, sp in enumerate(specs):
        length, s = len(sp.planted), sp.width
        offs = [4096 + 512 * i]
        if s == 2:
            offs.append(4096 + 512 * i + 257)  # odd byte alignment
        offs.append(next(seams) - 2 * s)
        offs.append(size - length - 96 * i)
        if i == 0:
            offs.append(chunk_bytes - 2 * s)  # the device-chunk seam
        plan[sp.name] = sorted(offs)
    spans = sorted(
        (o, o + len(sp.planted)) for sp in specs for o in plan[sp.name]
    )
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        if b0 < a1:
            raise ValueError(f"plants overlap at byte {b0}")
    if spans[0][0] < 0 or spans[-1][1] > size:
        raise ValueError("plant outside the file")
    return plan


def build_corpus(path: Path, size: int, seed: int, specs, plan) -> None:
    """Write *size* seeded random bytes with zero-filled runs to *path*,
    then the planted keywords at the offsets of *plan*."""
    rng = np.random.default_rng(seed)
    data = np.frombuffer(rng.bytes(size), dtype=np.uint8).copy()
    run_max = max(16, min(4 << 20, size // 64))
    for _ in range(8 + size // (64 << 20)):
        start = int(rng.integers(0, size))
        data[start : start + int(rng.integers(16, run_max))] = 0
    for sp in specs:
        enc = np.frombuffer(sp.planted, dtype=np.uint8)
        for off in plan[sp.name]:
            data[off : off + len(enc)] = enc
    path.parent.mkdir(parents=True, exist_ok=True)
    data.tofile(path)


def oracle_window_offsets(pat, path: Path, size: int, spec: Spec,
                          plant: int, margin: int = 64):
    """Byte offsets the Python oracle finds in a window around *plant*
    (on the plant's element grid)."""
    from monkey_moore_tpu.config import Endianness
    from monkey_moore_tpu.oracle import oracle_search
    from monkey_moore_tpu.preview import decode_elements

    s = spec.width
    a = plant % s
    w0 = max(a, plant - margin * s)
    w0 -= (w0 - a) % s
    w1 = min(size, plant + len(spec.planted) + margin * s)
    count = (w1 - w0) // s
    with open(path, "rb") as f:
        f.seek(w0)
        raw = f.read(count * s)
    endian = spec.config.get("endianness", Endianness.LITTLE)
    arr = decode_elements(raw, s, endian)
    return [w0 + e * s for e, _ in oracle_search(pat, arr)]


# ---------------------------------------------------------------------------
# Phases


def _card_prefix(card: str) -> str:
    return f"[{card}]"


def _pairs(results):
    return [(r.offset, r.values_map) for r in results]


def check_plants(spec: Spec, pat, path: Path, size: int, plan, results):
    """*results* hold a match overlapping every plant (a wildcard keyword
    may match one element early), and every match the Python oracle finds
    in a window around the plant."""
    offsets = {r.offset for r in results}
    for plant in plan[spec.name]:
        check(any(abs(o - plant) < len(spec.planted) for o in offsets),
              f"{spec.name}: no match at the plant at {plant}")
        window = oracle_window_offsets(pat, path, size, spec, plant)
        check(set(window) <= offsets,
              f"{spec.name}: oracle finds {window} near {plant}")


def run_search(spec: Spec, path: Path, size: int, plan, card: str,
               first: bool):
    """One search on the device route vs the host route; returns the device
    results and the engine's stats."""
    from monkey_moore_tpu.config import SearchConfig
    from monkey_moore_tpu.engine import SearchEngine

    cfg = SearchConfig(file_path=path, **spec.config)
    eng = SearchEngine(cfg)
    t0 = time.perf_counter()
    dev = eng.run()
    t_dev = time.perf_counter() - t0
    st = eng.last_stats
    check(not st.host_routed, f"{spec.name}: search took the host route")
    check(st.device_dispatches > 0, f"{spec.name}: no device dispatch")
    check(st.resident_upload_failures == 0,
          f"{spec.name}: the resident upload failed")
    if first:
        check(st.h2d_bytes > 0, f"{spec.name}: first search uploaded nothing")
    else:
        check(st.h2d_bytes == 0,
              f"{spec.name}: repeat search moved {st.h2d_bytes} H2D bytes")

    host_eng = SearchEngine(
        dataclasses.replace(cfg, host_latency_threshold_bytes=size)
    )
    host = host_eng.run()
    check(host_eng.last_stats.host_routed, f"{spec.name}: host route unused")
    check(_pairs(dev) == _pairs(host),
          f"{spec.name}: device results differ from the host route "
          f"({len(dev)} vs {len(host)})")
    check_plants(spec, eng.compile(), path, size, plan, dev)
    print(f"{_card_prefix(card)} search {spec.name}: {len(dev)} results, "
          f"offsets+maps == host route, {len(plan[spec.name])} plants "
          f"found, oracle windows subset; device {t_dev:.6f} s"
          f"{' (first search, includes upload)' if first else ''}, "
          f"dispatches {st.device_dispatches}, h2d {st.h2d_bytes} B",
          flush=True)
    return dev, st


def sweep_vs_read(path: Path, size: int, card: str, iters: int = 10):
    """Fused step over one resident 512 MiB chunk vs a plain XLA read of
    the same bytes (8-bit and 16-bit ``abcde``)."""
    import jax

    from bench import read_reduce_fn
    from monkey_moore_tpu.config import Endianness
    from monkey_moore_tpu.corpus import get_resident_corpus, resident_pad_bytes
    from monkey_moore_tpu.dense import TILE_ELEMS, fused_count_extract
    from monkey_moore_tpu.pattern import compile_pattern

    read = read_reduce_fn()
    out = {}
    for s in (1, 2):
        chunk_elems = DEVICE_CHUNK_BYTES // s
        want = chunk_elems + TILE_ELEMS
        corpus = get_resident_corpus(
            path, size, 12 << 30,
            resident_pad_bytes(DEVICE_CHUNK_BYTES, TILE_ELEMS),
        )
        check(corpus is not None, "resident corpus missing")
        grid = jax.block_until_ready(
            corpus.grid_chunk(s, Endianness.LITTLE, 0, 0, want)
        )
        pat = compile_pattern("abcde", dtype=np.uint8 if s == 1
                              else np.uint16)
        fused_count_extract(pat, grid, chunk_elems)  # compile
        jax.block_until_ready(read(grid))
        t_step, t_read = [], []
        for _ in range(iters):
            t0 = time.perf_counter()
            fused_count_extract(pat, grid, chunk_elems)  # fetches result
            t_step.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            jax.block_until_ready(read(grid))
            t_read.append(time.perf_counter() - t0)
        step = statistics.median(t_step)
        rd = statistics.median(t_read)
        # both read the same grid: one chunk plus its halo tile
        sweep_rate = grid.nbytes / step
        read_rate = grid.nbytes / rd
        out[s] = (sweep_rate, read_rate)
        print(f"{_card_prefix(card)} sweep vs read, {8 * s}-bit abcde, "
              f"resident {DEVICE_CHUNK_BYTES} B chunk: fused step median "
              f"{step:.6f} s = {sweep_rate:.6e} B/s; plain XLA read median "
              f"{rd:.6f} s = {read_rate:.6e} B/s; sweep/read "
              f"{sweep_rate / read_rate:.4f}", flush=True)
    return out


def run_conformance(card: str, seed: int) -> None:
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "conformance_gate", REPO / "tools" / "conformance_gate.py"
    )
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    rc = gate.main(["--trials", str(CONFORMANCE_TRIALS), "--device-route",
                    "--seed", str(seed)])
    check(rc == 0, "conformance gate failed on the device route")
    print(f"{_card_prefix(card)} conformance: {CONFORMANCE_TRIALS} trials "
          "on the device route, 0 failures", flush=True)


def run_cli(path: Path, want_offsets, card: str) -> None:
    from monkey_moore_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["search", str(path), "abcde", "--offsets", "dec",
                       "--no-progress"])
    check(rc == 0, f"cli.main returned {rc}")
    got = [int(line.split("\t")[0]) for line in buf.getvalue().splitlines()
           if line.strip()]
    check(got == want_offsets, "cli search differs from the engine")
    print(f"{_card_prefix(card)} cli search abcde: {len(got)} results == "
          "engine", flush=True)


def one_card(out_dir: Path, seed: int, card: str) -> None:
    import jax

    from monkey_moore_tpu.config import SearchConfig
    from monkey_moore_tpu.dense import TILE_ELEMS
    from monkey_moore_tpu.engine import SearchEngine
    from monkey_moore_tpu.multi import MultiSearcher

    specs, multi = one_card_specs()
    size = CD_IMAGE_BYTES
    plan = plan_plants(specs + multi, size, DEVICE_CHUNK_BYTES, TILE_ELEMS)
    path = out_dir / "cd_image_mode1.bin"
    t0 = time.perf_counter()
    build_corpus(path, size, seed, specs + multi, plan)
    print(f"corpus: {size} B seeded ({seed}) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    results = {}
    for i, spec in enumerate(specs):
        results[spec.name], _ = run_search(spec, path, size, plan, card,
                                           first=i == 0)

    # repeat searches on the resident corpus
    cfg = SearchConfig(file_path=path, **specs[0].config)
    times = []
    for _ in range(5):
        eng = SearchEngine(cfg)
        t0 = time.perf_counter()
        res = eng.run()
        times.append(time.perf_counter() - t0)
        check(_pairs(res) == _pairs(results[specs[0].name]),
              "repeat search differs")
        check(eng.last_stats.h2d_bytes == 0, "repeat search uploaded")
    stages = " ".join(
        f"{k}={v:.6f}s"
        for k, v in sorted(eng.last_stats.stage_seconds.items())
    )
    print(f"{_card_prefix(card)} repeat search {specs[0].name}: median of 5 "
          f"{statistics.median(times):.6f} s (runs {times}); stages "
          f"{stages}", flush=True)

    # one MultiSearcher batch of 8 keywords
    t0 = time.perf_counter()
    groups = MultiSearcher(path).search([sp.config["keyword"]
                                         for sp in multi])
    t_multi = time.perf_counter() - t0
    for sp, got in zip(multi, groups):
        host = SearchEngine(SearchConfig(
            file_path=path, host_latency_threshold_bytes=size, **sp.config
        )).run()
        check(_pairs(got) == _pairs(host), f"{sp.name}: differs from host")
        check(set(plan[sp.name]) <= {r.offset for r in got},
              f"{sp.name}: plant missing")
    print(f"{_card_prefix(card)} MultiSearcher batch of {len(multi)}: "
          f"== host route per keyword, {t_multi:.6f} s", flush=True)

    run_cli(path, [r.offset for r in results[specs[0].name]], card)
    sweep_vs_read(path, size, card)
    run_conformance(card, seed)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"{_card_prefix(card)} peak_bytes_in_use {peak}", flush=True)


def four_cards(out_dir: Path, seed: int, card: str) -> None:
    import jax

    from monkey_moore_tpu.config import SearchConfig
    from monkey_moore_tpu.dense import TILE_ELEMS
    from monkey_moore_tpu.engine import SearchEngine

    devices = jax.devices()[:4]
    check(len(devices) == 4, f"need 4 devices, have {len(jax.devices())}")
    specs = mesh_specs()
    size = MESH_CORPUS_BYTES
    plan = plan_plants(specs, size, DEVICE_CHUNK_BYTES, TILE_ELEMS)
    path = out_dir / "mesh_corpus_1gib.bin"
    build_corpus(path, size, seed, specs, plan)
    for spec in specs:
        cfg = SearchConfig(file_path=path, **spec.config)
        one = SearchEngine(cfg).run()
        t0 = time.perf_counter()
        SearchEngine(cfg).run()
        t_one = time.perf_counter() - t0
        mesh_cfg = dataclasses.replace(cfg, devices=devices)
        eng = SearchEngine(mesh_cfg)
        t0 = time.perf_counter()
        got = eng.run()
        t_first = time.perf_counter() - t0
        st = eng.last_stats
        check(_pairs(got) == _pairs(one),
              f"{spec.name}: 4-card results differ from one card")
        check(set(plan[spec.name]) <= {r.offset for r in got},
              f"{spec.name}: plant missing")
        check(st.device_dispatches > 0 and st.resident_upload_failures == 0,
              f"{spec.name}: mesh route not taken")
        rep = SearchEngine(mesh_cfg)
        t0 = time.perf_counter()
        again = rep.run()
        t_rep = time.perf_counter() - t0
        check(_pairs(again) == _pairs(one), f"{spec.name}: repeat differs")
        check(rep.last_stats.h2d_bytes == 0,
              f"{spec.name}: repeat moved {rep.last_stats.h2d_bytes} B H2D")
        print(f"{_card_prefix(card)} 4-card {spec.name}: {len(got)} results "
              f"== one card; first {t_first:.6f} s (h2d {st.h2d_bytes} B), "
              f"repeat {t_rep:.6f} s (h2d 0 B; one card {t_one:.6f} s); "
              f"dispatches "
              f"{rep.last_stats.device_dispatches}; per_device_candidates "
              f"{rep.last_stats.per_device_candidates}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    ap.add_argument("--out", type=Path, default=REPO / "out",
                    help="directory for the generated corpus")
    args = ap.parse_args(argv)

    try:
        sys.path.insert(0, str(REPO))
        from bench import card_line
    except ImportError as e:
        print(f"error: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    try:
        lines = card_line().splitlines()  # a child process; JAX not started
    except (OSError, subprocess.SubprocessError) as e:  # no nvidia-smi
        print(f"error: no NVIDIA card ({e})", file=sys.stderr)
        return 1
    for line in lines:
        print(f"card: {line}", flush=True)
    card = "; ".join(sorted(set(lines)))

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"error: JAX runs on {backend!r}, not a GPU", file=sys.stderr)
        return 1
    from monkey_moore_tpu.native import native_available
    from monkey_moore_tpu.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()
    try:
        check(native_available(), "the native host scanner did not build")
        if args.four_cards:
            four_cards(args.out, args.seed, card)
        else:
            one_card(args.out, args.seed, card)
    except SmokeFailure as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    dev0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform,
        "kind": dev0.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
