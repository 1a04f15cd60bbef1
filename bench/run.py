"""The benchmark of the PyTorch/CUDA port (`src/repro_torch`): one run of
one cell of `BENCHMARK.json`, its result as the last line of standard
output.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; it needs as many CUDA cards as the cell
asks for and exits with another code than 0 (and prints no result) without
them, or without the port beside it.
"""

import time

T_PROCESS = time.time()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]
# no library the port uses may load JAX behind its back
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

if __name__ == "__main__":
    from benchkit.cli import main
    sys.exit(main(t_process=T_PROCESS))
