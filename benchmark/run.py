"""One run of one benchmark cell (see README.md):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds the port (`vosesam_tpu_torch`).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# every build and kernel cache at a fixed path inside the checkout
_CACHE = os.path.join(ROOT, "build", "bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
os.environ["USE_FLAX"] = "0"
# one process with few threads: no idle OpenMP workers spinning beside the
# host thread that issues the card's work
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path[:0] = [BENCH, ROOT]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(t_start=T_START))
