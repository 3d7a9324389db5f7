"""PowerPaint on PyTorch and CUDA (the port of ``powerpaint_tpu``).

Public API:
    controller.PowerPaint          facade (load, route, composite)
    pipelines.inpaint.InpaintPipeline
    pipelines.brushnet.BrushNetPipeline
    pipelines.controlnet.ControlNetPipeline
    io.checkpoint.load_ppt_v1 / load_ppt_v2 / load_single_file /
        load_controlnet
    io.lora (LoRA and textual inversion on every pipeline)
    core.config                    model and pipeline configs
"""


def load(checkpoint_dir: str, version: str = "ppt-v1", **kwargs):
    """A ``PowerPaint`` controller from a checkpoint directory, on the card
    unless ``device="cpu"`` is passed (``PowerPaint.from_checkpoint``;
    ``controlnet_dir=`` adds the ppt-v1 + ControlNet pipeline)."""
    from powerpaint_tpu_torch.controller import PowerPaint

    return PowerPaint.from_checkpoint(checkpoint_dir, version, **kwargs)
