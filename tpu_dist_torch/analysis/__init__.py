"""Program analysis for the port (``tpu_dist/analysis``): the program
audit, :mod:`tpu_dist_torch.analysis.proglint`."""
