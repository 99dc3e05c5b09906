from .ckpt import latest_step, load_checkpoint, save_checkpoint
