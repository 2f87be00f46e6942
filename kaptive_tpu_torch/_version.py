r"""Version of the PyTorch/CUDA port of the kaptive-tpu framework (a static string, bumped per release)."""

__version__ = "0.1.0"
