"""Command-line tools of the port: the gather microbench, the probe kernel's
A/B timing across versions of its source, and the relocalization demo
(`python -m android_svo_tpu_torch.tools.<name>`)."""
