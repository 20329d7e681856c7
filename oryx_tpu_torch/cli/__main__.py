from oryx_tpu_torch.cli.main import run

run()
