"""The benchmark of the PyTorch and CUDA port (``tpu_dist_torch``): one
cell a run, ``python benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (``README.md``)."""
