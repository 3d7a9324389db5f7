"""Task-prompt construction — the four-tasks-from-one-model trick.

Faithful port of the PROMPT SEMANTICS of ``add_task``
(reference ``app.py:37-64``) and the v2 suffix rule (app.py:309-313):
task tokens (P_ctxt/P_shape/P_obj) are appended to positive/negative prompt
pairs, and shape-guided mode blends A=P_shape / B=P_ctxt embeddings by the
fitting degree.
"""

from __future__ import annotations

import dataclasses
TEXT_GUIDED = "text-guided"
SHAPE_GUIDED = "shape-guided"
OBJECT_REMOVAL = "object-removal"
OUTPAINTING = "image-outpainting"

TASKS = (TEXT_GUIDED, SHAPE_GUIDED, OBJECT_REMOVAL, OUTPAINTING)

_V1_NEG_SUFFIX = ", worst quality, low quality, normal quality, bad quality, blurry "


@dataclasses.dataclass(frozen=True)
class TaskPrompts:
    promptA: str
    promptB: str
    negative_promptA: str
    negative_promptB: str
    # v2 only: the plain prompt for the frozen base UNet (promptU)
    promptU: str = ""
    negative_promptU: str = ""


def add_task(
    prompt: str, negative_prompt: str, task: str, version: str = "ppt-v1"
) -> TaskPrompts:
    """(promptA, promptB, negA, negB) per task — reference app.py:37-64.

    For v2, callers should FIRST apply ``v2_prompt_suffix`` to ``prompt``
    (app.py:309-313); pos/neg prefixes are then empty strings and the task
    token stands alone, exactly as the reference composes them.
    """
    if task in (OBJECT_REMOVAL, OUTPAINTING):
        pos = f"empty scene blur {prompt}" if version == "ppt-v1" else ""
        neg = negative_prompt if version == "ppt-v1" else ""
        return TaskPrompts(
            promptA=pos + " P_ctxt",
            promptB=pos + " P_ctxt",
            negative_promptA=neg + " P_obj",
            negative_promptB=neg + " P_obj",
            promptU=prompt,
            negative_promptU=negative_prompt,
        )
    if task == SHAPE_GUIDED:
        pos = prompt if version == "ppt-v1" else ""
        neg = negative_prompt + _V1_NEG_SUFFIX if version == "ppt-v1" else ""
        return TaskPrompts(
            promptA=pos + " P_shape",
            promptB=pos + " P_ctxt",
            negative_promptA=neg + "P_shape",
            negative_promptB=neg + "P_ctxt",
            promptU=prompt,
            negative_promptU=negative_prompt,
        )
    # default: text-guided object inpainting
    pos = prompt if version == "ppt-v1" else ""
    neg = negative_prompt + _V1_NEG_SUFFIX if version == "ppt-v1" else ""
    return TaskPrompts(
        promptA=pos + " P_obj",
        promptB=pos + " P_obj",
        negative_promptA=neg + "P_obj",
        negative_promptB=neg + "P_obj",
        promptU=prompt,
        negative_promptU=negative_prompt,
    )


def v2_prompt_suffix(prompt: str, task: str) -> str:
    """ppt-v2 appends scene hints to the plain prompt (app.py:309-313)."""
    if task == OUTPAINTING:
        return prompt + " empty scene"
    if task == OBJECT_REMOVAL:
        return prompt + " empty scene blur"
    return prompt
