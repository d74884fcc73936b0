"""E2FGVI-HQ (Li et al., "Towards An End-to-End Framework for Flow-Guided
Video Inpainting", CVPR 2022; https://github.com/MCG-NKU/E2FGVI,
`model/e2fgvi_hq.py`) written out in plain PyTorch for the benchmark's
check: `generator.py`. It is written from the published model, not copied
from the port, and imports nothing of the port."""
