from .ckpt import CheckpointHandle, latest_step, restore, save, save_async
