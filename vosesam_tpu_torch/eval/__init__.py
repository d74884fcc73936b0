"""The evaluation harness (port of `vosesam_tpu/eval/`): DAVIS 2016 / 2017,
LongDataset, LVOS and OVIS loaders, J / F / AP metrics, the per-dataset
runners with their CSV ledgers, and a writer of synthetic dataset trees.
Runs on numpy, torch and the standard library; Pillow, pandas and imageio
are not needed (`codec.py` says what each image path needs)."""
