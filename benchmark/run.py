"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration and traffic mix are files under
``benchmark/`` found by name (see ``benchmark/harness.py``). Exits non-zero,
printing no result, without enough CUDA devices for the cell.
"""

import os
import sys
import time

START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Build and kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds; the program's gates and tokenizer at their
# defaults, whatever the caller's environment says.
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["USE_FLAX"] = "0"
for _key in [k for k in os.environ if k.startswith("FMM_TPU_")]:
    del os.environ[_key]
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != _HERE]

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, START))
