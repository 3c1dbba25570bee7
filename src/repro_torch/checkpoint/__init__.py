from .ckpt import AsyncSaver, latest_step, restore, save
