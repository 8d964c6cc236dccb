"""The benchmark of the PyTorch and CUDA port (`desktop2stereo_tpu_torch`):
`python stereobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.
See README.md."""
