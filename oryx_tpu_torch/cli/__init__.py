"""The port's ``oryx-run`` CLI: ``python -m oryx_tpu_torch.cli <command>``."""
