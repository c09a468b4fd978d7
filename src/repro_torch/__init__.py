"""PyTorch/CUDA port of the DP-SGD system (the JAX package ``repro`` is the
reference).  Imports ``torch`` and numpy only.  Entry points run on the card
unless the caller passes ``device="cpu"``."""
