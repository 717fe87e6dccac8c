# Development task runner (mirror of the reference's Justfile workflow)

# run the full test suite (CPU backend, 8 virtual devices)
test:
    python -m pytest tests/ -q

# run tests matching a keyword expression
test-k EXPR:
    python -m pytest tests/ -q -k "{{EXPR}}"

# conformance gate: engine vs exact reference oracle on randomized corpora
conformance:
    python tools/conformance_gate.py --cpu --trials 60

# cross-validate the Python oracle against a compiled reference build
refcheck:
    mkdir -p /tmp/refcheck
    g++ -O2 -std=c++17 -I/root/reference/include tools/refcheck/harness.cpp \
        /root/reference/src/core/monkey_moore.cpp -o /tmp/refcheck/refsearch
    python tools/refcheck/crosscheck.py

# headline benchmark (one JSON line; runs on the default JAX backend)
benchmark:
    python bench.py

# full benchmark matrix mirroring the reference's suites
benchmark-all:
    python tools/bench_all.py

# multi-device scaling check on virtual CPU devices
scaling:
    python tools/bench_scaling.py

# the five BASELINE.json measurement configs as one table
baseline-configs:
    python tools/bench_baseline_configs.py

# end-to-end smoke on one NVIDIA GPU (exact vs the host route)
smoke-gpu:
    python chip_smoke.py

# conformance gate on the GPU's device route, with a JSON artifact
conformance-gpu:
    python tools/conformance_gate.py --device-route --trials 120 --json out/conformance_gpu.json

# tests that need an NVIDIA card
test-gpu:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/ -q

# scripted two-session pty drive of the terminal UI
tui-smoke:
    python tools/tui_smoke.py

# build the native walker shared library
native:
    python -c "from monkey_moore_tpu.native import build_library; print(build_library(force=True))"
