"""Training side of the port: the optimizer (``optim.py``), the
pretraining and MELINOE fine-tuning loops and the deployment merge of a
fine-tune's LoRA adapters (``trainer.py``), and checkpoints
(``checkpoint.py``)."""
from .checkpoint import load_checkpoint, save_checkpoint
from .optim import OptConfig, adamw_update, global_norm, init_opt_state, schedule
from .trainer import (TRAIN_KERNEL_BACKEND, TrainResult, eval_nll, melinoe_finetune,
                      merge_lora, pretrain, train_runtime)

__all__ = ["load_checkpoint", "save_checkpoint", "merge_lora", "OptConfig",
           "adamw_update", "global_norm", "init_opt_state", "schedule",
           "TRAIN_KERNEL_BACKEND", "TrainResult", "eval_nll", "melinoe_finetune",
           "pretrain", "train_runtime"]
