"""Command-line entry points of the port, run as
``python -m image2video_synthesis_using_cinns_tpu_torch.cli.<name>``."""
