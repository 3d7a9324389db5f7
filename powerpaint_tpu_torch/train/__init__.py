"""Training (the JAX package's ``train/``): the losses of every
fine-tuning mode the PowerPaint recipe needs (arXiv 2312.03594 §4: task
tokens trained jointly with the inpainting UNet; the BrushNet branch
trained with the base frozen), LoRA and LCM-LoRA distillation, the train
step (AdamW with freezing labels, clipping, accumulation, EMA), the loop
with exact resume, and the command line.

- ``modes``: "v1" (UNet + text encoder + task tokens), "task_tokens" (only
  the learned task-prompt rows), "v2" (BrushNet branch + its text encoder;
  base UNet/VAE frozen), "lora" (low-rank adapters on the attention and
  feed-forward projections, exportable to the formats io/lora.py loads)
  and "lcm_distill".
- bf16 compute with fp32 master parameters (``models.layers.
  cast_for_compute``); the hand kernels' gradients recompute their plain
  versions (``ops._grad``).
- One process, or a mesh of them (``train.step.replicate_state``,
  ``fsdp_state``; ``--mesh N [--fsdp]`` on the command line): data
  parallel, ZeRO-3, or tensor parallel.
"""

from powerpaint_tpu_torch.train.data import (  # noqa: F401
    SyntheticSource,
    batches,
    build_prompt_ids,
)
from powerpaint_tpu_torch.train.loss import make_v1_loss, make_v2_loss  # noqa: F401
from powerpaint_tpu_torch.train.lora import (  # noqa: F401
    apply_lora,
    export_lora_sd,
    init_lora_tree,
)
from powerpaint_tpu_torch.train.masks import random_mask  # noqa: F401
from powerpaint_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    make_train_step,
    trainable_mask,
)
from powerpaint_tpu_torch.train.trainer import (  # noqa: F401
    Trainer,
    load_train_state,
    save_train_state,
)
