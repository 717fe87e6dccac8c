#!/usr/bin/env python
"""Measure the five BASELINE.json measurement configs as one table.

BASELINE.json lists five north-star configurations (512 KB synthetic ROM
→ 1 GB custom-sequence multi-shard corpus).  This harness builds each
corpus, runs the PRODUCTION engine routing on it (small ROMs ride the
host latency path — a device dispatch's fixed cost exceeds the whole
scan; the 1 GB corpus rides the resident device path), verifies planted
matches are found, and writes ``out/BASELINE_CONFIGS.json`` with one
row per config: route, end-to-end bytes/s (best repeat search), first-run
seconds (compile + upload), and result counts.

Config 5's "2+ hosts" clause is validated structurally in-process where
multiple devices exist (the mesh path: identical offsets, one collective
dispatch, zero repeat H2D) and by the real 2-process DCN test in
``tests/test_multihost.py``; this harness records the mesh check when the
backend exposes ≥2 devices, else marks it deferred to that test.

Usage:
  python tools/bench_baseline_configs.py            # spec sizes
  python tools/bench_baseline_configs.py --cpu --scale 16
      # CPU smoke: every size divided by 16, 8 virtual devices
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CONFIG_TEXTS = [
    "8-bit relative search, single pattern 'code'-style, 512 KB synthetic "
    "ROM (CPU-runnable via tests/test_search_engine corpus)",
    "8-bit relative search with wildcards, multi-match, 4 MB ROM image",
    "16-bit search, big- and little-endian, SNES/GBA-style 8 MB binary",
    "value-scan mode: raw numeric sequence → inferred relative deltas "
    "over 64 MB blob",
    "custom character-sequence (Kana/Kanji table) search over 1 GB "
    "multi-shard corpus, 2+ hosts",
]

# romaji stand-in for a kana table: a custom character sequence assigns
# table indices exactly like the reference's Hiragana defaults
# (``sequences.py``) — the search math is index-based either way
KANA_SEQ = "aiueokstnhmyrw.,!?-0123456789"


def timed_runs(engine_factory, iters):
    """(first_run_s, best_repeat_s, last_engine) for a config."""
    t0 = time.perf_counter()
    eng = engine_factory()
    eng.run()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(iters):
        eng = engine_factory()
        t0 = time.perf_counter()
        eng.run()
        best = min(best, time.perf_counter() - t0)
    return first, best, eng


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every spec size by this (CPU smoke runs)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json", type=Path,
                    default=REPO / "out" / "BASELINE_CONFIGS.json")
    args = ap.parse_args()

    import os

    if args.cpu and "xla_force_host_platform_device_count" not in (
        os.environ.get("XLA_FLAGS", "")
    ):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from monkey_moore_tpu.config import Endianness, SearchConfig
    from monkey_moore_tpu.engine import SearchEngine
    from monkey_moore_tpu.parallel import resident

    rng = np.random.default_rng(42)
    td = Path(tempfile.mkdtemp())
    rows = []

    def run_row(cfg_kwargs, n_bytes, planted, label, extra=None):
        def factory():
            return SearchEngine(SearchConfig(**cfg_kwargs))

        first, best, eng = timed_runs(factory, args.iters)
        offs = [r.offset for r in eng.run()]
        found = all(p in offs for p in planted)
        row = {
            "config": label,
            "size_bytes": n_bytes,
            "route": (
                "host" if eng.last_stats.host_routed else
                ("mesh" if cfg_kwargs.get("devices") else "device")
            ),
            "bytes_per_s": n_bytes / best,
            "first_run_s": first,
            "results": len(offs),
            "planted_found": bool(found),
        }
        if extra:
            row.update(extra)
        rows.append(row)
        print(
            f"{label[:58]:<58} {n_bytes / best / 1e9:7.2f} GB/s "
            f"[{row['route']}] results={len(offs)} "
            f"planted_ok={found}", flush=True,
        )
        return row

    # --- 1: 512 KB synthetic ROM, 4-char keyword --------------------------
    n1 = 512 * 1024 // args.scale
    data = rng.integers(0, 256, n1).astype(np.uint8)
    enc = np.array([(ord(c) + 7) % 256 for c in "code"], dtype=np.uint8)
    planted1 = [n1 // 5, n1 // 2, n1 - 4]
    for p in planted1:
        data[p : p + 4] = enc
    p1 = td / "rom512k.bin"
    p1.write_bytes(data.tobytes())
    run_row(dict(file_path=p1, keyword="code"), n1, planted1,
            CONFIG_TEXTS[0])

    # --- 2: 4 MB ROM, wildcard keyword, multi-match -----------------------
    n2 = 4 * 1024 * 1024 // args.scale
    data = rng.integers(0, 256, n2).astype(np.uint8)
    kw2 = "mon*ey"
    enc = np.array(
        [(ord(c) + 11) % 256 if c != "*" else 199 for c in kw2],
        dtype=np.uint8,
    )
    planted2 = sorted(
        int(x) for x in rng.integers(0, n2 - len(kw2), 6)
    )
    for p in planted2:
        data[p : p + len(kw2)] = enc
    p2 = td / "rom4m.bin"
    p2.write_bytes(data.tobytes())
    run_row(dict(file_path=p2, keyword=kw2, wildcard="*"), n2,
            planted2, CONFIG_TEXTS[1])

    # --- 3: 8 MB binary, 16-bit, both endiannesses ------------------------
    n3 = 8 * 1024 * 1024 // args.scale
    elems = rng.integers(0, 65536, n3 // 2).astype(np.uint16)
    kw16 = np.array(
        [(ord(c) + 500) % 65536 for c in "abcde"], dtype=np.uint16
    )
    planted_e = [1000, n3 // 4, n3 // 2 - 10]  # element offsets
    for p in planted_e:
        elems[p : p + 5] = kw16
    for endian, order in ((Endianness.BIG, ">u2"),
                          (Endianness.LITTLE, "<u2")):
        p3 = td / f"bin8m_{order[0] == '>'}.bin"
        p3.write_bytes(elems.astype(order).tobytes())
        run_row(
            dict(file_path=p3, keyword="abcde", element_width=2,
                 endianness=endian),
            n3, [2 * p for p in planted_e],
            CONFIG_TEXTS[2] + f" [{endian.name}]",
        )

    # --- 4: 64 MB blob, value-scan ----------------------------------------
    n4 = 64 * 1024 * 1024 // args.scale
    data = rng.integers(0, 256, n4).astype(np.uint8)
    values = [40, 30, 20, 10, 50]
    planted4 = [123, n4 // 3, n4 - 8]
    for p in planted4:
        data[p : p + 5] = (np.array(values) + 77) % 256
    p4 = td / "blob64m.bin"
    p4.write_bytes(data.tobytes())
    run_row(
        dict(file_path=p4, is_relative_search=False,
             reference_values=values),
        n4, planted4, CONFIG_TEXTS[3],
    )

    # --- 5: 1 GB custom-sequence corpus, multi-shard ----------------------
    n5 = 1024 * 1024 * 1024 // args.scale
    kw5 = "kana-0"
    idx = {c: i for i, c in enumerate(KANA_SEQ)}
    enc5 = np.array(
        [(idx[c] + 31) % 256 for c in kw5], dtype=np.uint8
    )
    planted5 = [77, n5 // 2 + 1, n5 - len(kw5)]
    p5 = td / "corpus1g.bin"
    # stream the corpus to disk in 64 MiB slabs (1 GiB in one array is
    # avoidable host RAM); plant after the fact via seek
    with open(p5, "wb") as fh:
        slab = 64 * 1024 * 1024
        left = n5
        while left:
            m = min(slab, left)
            fh.write(
                rng.integers(0, 256, m, dtype=np.uint8).tobytes()
            )
            left -= m
    with open(p5, "r+b") as fh:
        for p in planted5:
            fh.seek(p)
            fh.write(enc5.tobytes())
    extra5 = {}
    if len(jax.devices()) >= 2:
        # multi-shard structural check: the mesh path must return the
        # identical offsets with ONE collective dispatch and zero repeat
        # H2D (the per-process analog of the 2-host DCN run, which the
        # real 2-process test in tests/test_multihost.py covers)
        resident.clear_sharded_corpus_cache()
        d = min(8, len(jax.devices()))
        cfgm = dict(
            file_path=p5, keyword=kw5, custom_char_seq=KANA_SEQ,
            devices=list(jax.devices()[:d]),
        )
        em = SearchEngine(SearchConfig(**cfgm))
        offs_mesh = [r.offset for r in em.run()]
        em2 = SearchEngine(SearchConfig(**cfgm))
        offs_mesh2 = [r.offset for r in em2.run()]
        extra5["multi_shard"] = {
            "n_devices": d,
            "planted_found": all(p in offs_mesh for p in planted5),
            "repeat_identical": offs_mesh == offs_mesh2,
            "device_dispatches": em2.last_stats.device_dispatches,
            "h2d_bytes_repeat": em2.last_stats.h2d_bytes,
            "ici_halo_bytes": em2.last_stats.ici_halo_bytes,
        }
    else:
        # single-device session (the real chip): run the multi-shard
        # structural check in a CPU subprocess over 8 virtual devices on
        # the SAME corpus file (the real 2-process DCN analog lives in
        # tests/test_multihost.py)
        import subprocess

        check = (
            "import os, json, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS','') +"
            " ' --xla_force_host_platform_device_count=8')\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "from monkey_moore_tpu.config import SearchConfig\n"
            "from monkey_moore_tpu.engine import SearchEngine\n"
            f"cfg = dict(file_path={str(p5)!r}, keyword={kw5!r}, "
            f"custom_char_seq={KANA_SEQ!r}, "
            "devices=list(jax.devices()[:8]))\n"
            "e = SearchEngine(SearchConfig(**cfg))\n"
            "offs = [r.offset for r in e.run()]\n"
            "e2 = SearchEngine(SearchConfig(**cfg))\n"
            "offs2 = [r.offset for r in e2.run()]\n"
            f"planted = {planted5!r}\n"
            "print(json.dumps({\n"
            "    'n_devices': 8, 'backend': 'cpu-virtual',\n"
            "    'planted_found': all(p in offs for p in planted),\n"
            "    'repeat_identical': offs == offs2,\n"
            "    'device_dispatches': e2.last_stats.device_dispatches,\n"
            "    'h2d_bytes_repeat': e2.last_stats.h2d_bytes,\n"
            "    'ici_halo_bytes': e2.last_stats.ici_halo_bytes,\n"
            "}))\n"
        )
        try:
            out = subprocess.run(
                [sys.executable, "-c", check], capture_output=True,
                text=True, timeout=1800,
            )
            extra5["multi_shard"] = json.loads(
                out.stdout.strip().splitlines()[-1]
            )
        except Exception as e:
            extra5["multi_shard"] = {
                "note": f"virtual-mesh subprocess failed ({e}); structure "
                        "is gated by tests/test_parallel.py and the real "
                        "2-process DCN test in tests/test_multihost.py"
            }
    row5 = run_row(
        dict(file_path=p5, keyword=kw5, custom_char_seq=KANA_SEQ),
        n5, planted5, CONFIG_TEXTS[4], extra=extra5,
    )
    # the single-chip device route uploads once then stays resident: the
    # repeat rate above excludes the first run's upload, which is the
    # interactive ROM-exploration workload; surface the split explicitly
    row5["first_run_includes_upload"] = row5["route"] != "host"

    blob = {
        "scale_divisor": args.scale,
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "iters": args.iters,
        "note": (
            "bytes_per_s is the best repeat-search end-to-end rate under "
            "PRODUCTION routing (host latency path for small ROMs — a "
            "device dispatch's fixed cost exceeds the whole scan; "
            "resident device path for the 1 GB corpus).  first_run_s "
            "includes pattern compile + corpus upload where applicable."
        ),
        "rows": rows,
    }
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps(blob, indent=2) + "\n")
    print(f"written: {args.json}")
    if not all(r["planted_found"] for r in rows):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
