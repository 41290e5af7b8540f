from .checkpointer import (AsyncCheckpointer, latest_step,  # noqa: F401
                           restore_checkpoint, save_checkpoint)
