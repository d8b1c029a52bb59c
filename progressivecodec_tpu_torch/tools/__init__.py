"""Command-line tools of the port (`python -m progressivecodec_tpu_torch.tools.<name>`)."""
