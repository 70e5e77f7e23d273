"""The benchmark of surfd_tpu_torch, the PyTorch and CUDA port of Surf-D.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. A cell's
configuration is `configs/<config>.json`, its traffic `workloads/<cell>.json`
(read by the general drivers in `kinds/`), each per-layer metric a reader in
`metrics/<metric>.py`; the plain references are in `reference/`.
"""
