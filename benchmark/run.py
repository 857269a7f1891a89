"""One run of one cell of the benchmark of cusdr_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line last on
standard output and the numbers the comparison held to their limits as the
last lines of standard error; exits non-zero, with no result, where the
machine has fewer CUDA devices than the cell asks for or where the process
has loaded jax or the JAX package.  The kernels build once into
cusdr_tpu_torch/ops/build/ inside the checkout; every other cache goes
under the checkout's .cache/.  The host's thread pools (torch's, OpenMP's,
MKL's, OpenBLAS's) hold ``THREADS`` threads each."""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / ".cache" / sub)
os.environ["USE_FLAX"] = "0"
# the host's thread pools fixed, so that every run loads the host alike
THREADS = 4
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(THREADS)
sys.path.insert(0, str(ROOT))

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS, Path.cwd(), THREADS))
