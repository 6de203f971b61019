"""Entry point of the benchmark: one run of one cell.

    python3 clambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as its last line of standard output, and the
numbers its comparison read, each beside its limit, as its last lines of
standard error. Exits with another code than 0, printing no result, where
the cell's CUDA devices are missing or JAX was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# caches that a kernel build or compile writes, at fixed paths in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(REPO / ".clambench_cache" / sub)
sys.path.insert(0, str(REPO))

from clambench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
