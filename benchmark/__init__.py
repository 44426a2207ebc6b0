"""The benchmark of parsenet_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: BENCHMARK.json names the cells,
configurations and metrics; benchmark/workloads/<cell>.json names the
configuration (benchmark/configs/<config>.json), the traffic mix
(benchmark/mixes/<traffic>.json) and the module of the entry the window
drives (benchmark/drivers/<driver>.py); each per-layer metric has its
reader in benchmark/metrics/<metric>.py. benchmark/reference/ is the plain
reference that decides `correct`, benchmark/counts/ the operation and byte
counts with the peaks.
"""
