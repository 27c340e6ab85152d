"""RL training data (layoutllm_t2i_tpu/data/rl_data.py): for now only the
JSON reader that the generation CLI's candidate pool needs. The COCO2014
sample/candidate files hold {"id": [...], "data": [{img_id, name, width,
height, bbox (center-normalized xcycwh), label, captions}, ...]}."""
from __future__ import annotations

import json


def load_json(path: str):
    with open(path) as f:
        return json.load(f)
