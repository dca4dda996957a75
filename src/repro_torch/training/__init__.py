"""Training-side helpers of the port: checkpoints (``checkpoint.py``) and
the deployment merge of a fine-tune's LoRA adapters (``trainer.py``).
The training loops themselves wait for the training slice."""
from .checkpoint import load_checkpoint, save_checkpoint
from .trainer import merge_lora

__all__ = ["load_checkpoint", "save_checkpoint", "merge_lora"]
