"""Command-line tools of the port: the gather microbench and the
relocalization demo (`python -m android_svo_tpu_torch.tools.<name>`)."""
