"""Layout planner: policy-scored in-context example selection + LLM layout
generation + parsing (a copy of layoutllm_t2i_tpu/pipeline/planner.py,
host-only; the port keeps its own copy).

Reference behavior: models/policy.py:11-33 (PolicyNetwork), base_prompt.py
(prompt construction — the template text is part of the task spec and must
match for LLM parity), models/llm.py (cached ChatCompletion client),
utils.py:78-101 (regex extraction, box-format conversion),
txt2img.py:416-451 / train_rl.py:36-56 (selection logic).

All host-side, pure Python/NumPy; the only device work is the policy linear,
which callers run via models/policy.py. ``LLMClient`` imports ``openai``
only when it is called; ``CachedLayoutLLM`` is the offline path.
"""
from __future__ import annotations

import json
import os
import re
import time
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# prompt construction (behavioral spec from base_prompt.py)

_TASK_INTRO = (
    "Now you are an assistant to help me design a layout given a description. "
    'Concretely, a layout denotes a set of "object: bounding box" item. '
    '"object" means any object name in the world, while "bounding box" is '
    'formulated as [x, y, w, h], where "x, y" denotes the top left coordinate '
    'of the bounding box, "w" denotes the width, and "h" denotes the height. '
    'The six values "x, y, w, h, x+w, y+h" are all larger than 0 and smaller '
    "than 1. "
)

_FEW_SHOT_TAIL = (
    "Next, I will give you several examples for you to understand this task."
)

_ZERO_SHOT_TAIL = (
    "Next, I will give you an input which describes an image, and then you "
    'should give me an output with the format "'
    "\noutput:\nobject: [x, y, w, h], \nobject: [x, y, w, h],\n...\n\""
)


def add_prefix(example: str, query: str) -> str:
    tail = _FEW_SHOT_TAIL if example != "" else _ZERO_SHOT_TAIL
    return f"{_TASK_INTRO}{tail}\n{example}\n{query}"


def format_example(captions: str, labels: Sequence[str],
                   boxes_xcycwh: Sequence[Sequence[float]]) -> str:
    """One in-context input/output pair; boxes given center-format are emitted
    top-left at 2 decimals (base_prompt.py:26-39)."""
    lines = ["output: "]
    for label, (xc, yc, w, h) in zip(labels, boxes_xcycwh):
        box = [round(v, 2) for v in (xc - w / 2, yc - h / 2, w, h)]
        lines.append(f"{label}: {box}")
    return f"\ninput: {captions}\n" + "\n".join(lines) + "\n"


def build_prompt(shot_examples: List[Dict], test_caption: str) -> str:
    in_context = "".join(
        format_example(ex["captions"], ex["label"], ex["bbox"]) for ex in shot_examples
    )
    query = (
        f"input: {test_caption} (No explanation. Must give an output or try to "
        "imagine a possible output even if the given description is incomplete. )"
    )
    return add_prefix(in_context, query)


# --------------------------------------------------------------------------
# output parsing (utils.py:78-101)

_PRED_RE = re.compile(
    r"\b(\w+\s*\w*)\s*:\s*\[(\d+\.\d+),\s*(\d+\.\d+),\s*(\d+\.\d+),\s*(\d+\.\d+)\]"
)


def extract_prediction(text: str) -> Tuple[List[str], List[List[float]]]:
    categories, bboxes = [], []
    for m in _PRED_RE.findall(text):
        categories.append(m[0])
        bboxes.append([float(m[1]), float(m[2]), float(m[3]), float(m[4])])
    return categories, bboxes


def center2lefttop(boxes):
    return [[xc - w / 2, yc - h / 2, w, h] for xc, yc, w, h in boxes]


# --------------------------------------------------------------------------
# policy scoring / example selection


def select_topk_shots(scores_row: np.ndarray, shot_number: int) -> List[int]:
    """Greedy top-k, reversed so the most relevant example sits closest to the
    query (txt2img.py:429-431)."""
    order = sorted(range(len(scores_row)), key=lambda i: scores_row[i], reverse=True)
    return order[:shot_number][::-1]


def sample_shots(scores_row: np.ndarray, shot_number: int,
                 rng: Optional[np.random.Generator] = None) -> List[int]:
    """On-policy sampling without replacement from the score distribution
    (train_rl.py:38-48). scores_row must already be softmaxed."""
    rng = rng or np.random.default_rng()
    p = np.nan_to_num(np.asarray(scores_row, dtype=np.float64), nan=1e-6)
    p = p / p.sum()
    cids = rng.choice(len(p), size=shot_number, replace=False, p=p)
    return list(cids[::-1])


# --------------------------------------------------------------------------
# LLM client


class LLMClient:
    """OpenAI-compatible chat client with in-memory cache and exponential
    backoff (models/llm.py — the reference's backoff is commented out; here it
    works)."""

    def __init__(self, engine: str = "gpt-3.5-turbo", temperature: float = 0.0,
                 max_tokens: int = 512, presence_penalty: float = 0.0,
                 frequency_penalty: float = 0.0, max_retries: int = 5,
                 logger=None):
        self.engine = engine
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.presence_penalty = presence_penalty
        self.frequency_penalty = frequency_penalty
        self.max_retries = max_retries
        self.logger = logger
        self._cached_call = lru_cache(maxsize=10000)(self._call)

    def _call(self, prompt: str) -> str:
        import openai  # gated: host-only optional dependency

        delay = 1.0
        for attempt in range(self.max_retries):
            try:
                response = openai.ChatCompletion.create(
                    model=self.engine,
                    temperature=self.temperature,
                    max_tokens=self.max_tokens,
                    presence_penalty=self.presence_penalty,
                    frequency_penalty=self.frequency_penalty,
                    messages=[
                        {"role": "system", "content": "You are a helpful assistant."},
                        {"role": "user", "content": prompt},
                    ],
                )
                return response["choices"][0]["message"]["content"]
            except Exception:
                if attempt == self.max_retries - 1:
                    raise
                time.sleep(delay)
                delay *= 2

    def __call__(self, prompt: str) -> str:
        out = self._cached_call(prompt)
        if self.logger is not None:
            self.logger.write(prompt)
            self.logger.write(out)
            self.logger.write("#" * 55)
        return out

    def cache_info(self):
        return self._cached_call.cache_info()


class CachedLayoutLLM:
    """Offline stand-in: serves layouts from a JSON file mapping caption ->
    raw LLM output text (or -> {label: box} dicts). Keeps benches and CI free
    of any network dependency (SURVEY.md §4e)."""

    def __init__(self, cache_path: str):
        with open(cache_path) as f:
            self.cache = json.load(f)

    def __call__(self, prompt: str) -> str:
        # the query caption is on the last 'input:' line
        m = re.findall(r"input: (.*?) \(No explanation", prompt)
        key = m[-1] if m else prompt
        entry = self.cache.get(key)
        if entry is None:
            return ""
        if isinstance(entry, str):
            return entry
        lines = ["output:"]
        for label, box in entry:
            lines.append(f"{label}: [{box[0]:.2f}, {box[1]:.2f}, {box[2]:.2f}, {box[3]:.2f}]")
        return "\n".join(lines)


def plan_layouts(llm, scores: np.ndarray, cand_examples: List[Dict],
                 captions: List[str], shot_number: int = 2,
                 sample: bool = False, rng=None):
    """scores: (B, num_cands). Returns per-caption (categories, boxes_xywh,
    raw_output, shot_ids) — the planner core of txt2img.py:416-451."""
    results = []
    for i, caption in enumerate(captions):
        row = np.asarray(scores[i])
        cids = (sample_shots(row, shot_number, rng) if sample
                else select_topk_shots(row, shot_number))
        shots = [cand_examples[c] for c in cids]
        prompt = build_prompt(shots, caption)
        output = llm(prompt)
        categories, boxes = extract_prediction(output)
        results.append((categories, boxes, output, cids))
    return results
