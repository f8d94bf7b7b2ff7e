"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Prints one JSON line last on standard output (harness.py says what it
holds); exits non-zero, printing no result, without the devices.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root, for the benchmark package and the program
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
# keep libraries that the program loads from loading JAX by themselves
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# one intra-op CPU thread, whatever the environment says: the load comes
# from one process with few threads. With the default pool (a thread a
# core) the device-sampler cell read 0.1-8.8 % slower a step and 4-15 %
# slower at the 95th percentile on three seeds; the full-graph cell read
# the same (NVIDIA H100 80GB HBM3 host, 8 cores; PERF.md, PR 17)
os.environ["OMP_NUM_THREADS"] = "1"

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
