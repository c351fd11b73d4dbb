"""Run one cell of the benchmark of vstnet_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for (BENCHMARK.json). Prints one JSON object as the last line of
standard output; see benchmark/core/session.py. Set-up is timed from the
first line of this file.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches at fixed places inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)
sys.path.insert(0, ROOT)

from benchmark.core import session  # noqa: E402

if __name__ == "__main__":
    sys.exit(session.main(sys.argv[1:], T_START))
