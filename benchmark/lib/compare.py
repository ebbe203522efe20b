"""What every family's comparison shares: the program's annos of one frame
(per class the kept boxes [x, y, z, l, w, h, yaw] and their scores) read
into tensors after the checks that make numbers of them possible, and the
shape of a judged frame. How a frame is judged is the family's
(`benchmark/families/<family>.py`: `check_frame`).

A kept box or score of the program that is not finite, a score outside
[0, 1], or a class name the configuration does not have is reported by
name, frame, class and slot and makes the run not correct; it is never
turned into a number.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SCORE_CLAMP = 1e-7


class BadOutput(Exception):
    """An output of the program that no number can be made of."""


class Checked(NamedTuple):
    """One frame judged by a family: the numbers compared (names as in the
    configuration's `compare_limits`), the valid candidate count of each
    of the frame's NMS rows in the reference, and a line for the log."""

    numbers: dict[str, float]
    valid: list[int]
    note: str


def logit(s: torch.Tensor) -> torch.Tensor:
    s = s.clamp(SCORE_CLAMP, 1.0 - SCORE_CLAMP)
    return torch.log(s) - torch.log1p(-s)


def annos_tensors(annos: dict, class_names, device, where: str):
    """The program's annos of one frame → per class (boxes (m, 7), scores
    (m,)), after the finiteness and range checks."""
    names = np.asarray(annos["name"])
    boxes = np.concatenate([np.asarray(annos["location"], np.float64).reshape(-1, 3),
                            np.asarray(annos["dimensions"], np.float64).reshape(-1, 3),
                            np.asarray(annos["rotation_y"], np.float64).reshape(-1, 1)], axis=1)
    scores = np.asarray(annos["score"], np.float64).reshape(-1)
    out = []
    for ci, name in enumerate(class_names):
        sel = np.nonzero(names == name)[0]
        for field, arr in (("box", boxes[sel]), ("score", scores[sel, None])):
            bad = np.argwhere(~np.isfinite(arr))
            if len(bad):
                raise BadOutput(f"{where}: {field} of class {name} not finite at slot {int(bad[0][0])} "
                                f"({arr[bad[0][0]].tolist()})")
        s = scores[sel]
        bad = np.nonzero((s < 0.0) | (s > 1.0))[0]
        if len(bad):
            raise BadOutput(f"{where}: score of class {name} outside [0, 1] at slot {int(bad[0])} ({s[bad[0]]})")
        out.append((torch.as_tensor(boxes[sel], dtype=torch.float32, device=device),
                    torch.as_tensor(s, dtype=torch.float32, device=device)))
    unknown = set(names.tolist()) - set(class_names)
    if unknown:
        raise BadOutput(f"{where}: class names {sorted(unknown)} are not the configuration's")
    return out
