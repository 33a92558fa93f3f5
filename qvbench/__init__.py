"""The benchmark of the PyTorch and CUDA port (quickvideo_tpu_torch).

`python qvbench/run.py --workload <name> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json once; README.md says how the cells,
mixes and metrics are laid out and how to add one.
"""
