from repro_torch.checkpoint.checkpoint import (latest_step,  # noqa: F401
                                               load_checkpoint,
                                               save_checkpoint)
