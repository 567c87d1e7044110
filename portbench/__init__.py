"""The benchmark of `nu_scaler_tpu_torch` on an NVIDIA card: one command runs
one cell (a configuration under a traffic mix) once. See README.md."""
