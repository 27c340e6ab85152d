"""The port's copies of eval/caption_metrics.py and eval/synonyms.py against
the JAX package's, on the CPU.

Both are host-only Python over float64, so every function is held to exact
equality on one fixed set of candidates and references: BLEU-1..4,
ROUGE-L, CIDEr-D, METEOR (each matcher-stage prefix), SPICE-lite and its
tuples, the Porter stemmer, the alignment, ``get_all_metrics``; the
vendored synonym table and its index; and the ``LLT2I_SYNONYM_JSON``
override in both packages.
"""
import json

import pytest

from layoutllm_t2i_tpu.eval import caption_metrics as jcm
from layoutllm_t2i_tpu.eval import synonyms as jsyn

from layoutllm_t2i_torch.eval import caption_metrics as pcm
from layoutllm_t2i_torch.eval import synonyms as psyn

CANDS = [
    "a man riding a small bike down the street",
    "two dogs running on the grass near a fence",
    "a photo of a large couch in a living room",
    "a cat sitting on top of a laptop",
    "the and that",
    "",
    "a woman holding an umbrella next to a big red bus",
]
REFS = [
    ["a guy rides a little bicycle on the road", "a man on a bike"],
    ["dogs run in the grass", "two puppies playing beside a fence"],
    ["a picture of a big sofa", "a living room with a couch"],
    ["a kitten on a computer", "a cat is laying on a laptop keyboard"],
    ["the and with"],
    ["an empty caption reference"],
    ["a lady with a parasol beside a large bus", "a woman and a red bus"],
]
WORDS = ["running", "caresses", "ponies", "relational", "conditional",
         "rational", "generalization", "hopeful", "goodness", "adjustable",
         "agreed", "sized", "hopping", "electrical", "probate", "rate",
         "controlling", "roll", "skies", "a", "by", "motoring", "happy"]


def test_corpus_metrics_equal_jax():
    assert pcm.bleu(CANDS, REFS) == jcm.bleu(CANDS, REFS)
    assert pcm.bleu(CANDS, REFS, max_n=2) == jcm.bleu(CANDS, REFS, max_n=2)
    assert pcm.rouge_l(CANDS, REFS) == jcm.rouge_l(CANDS, REFS)
    assert pcm.rouge_l(CANDS, REFS, beta=2.0) == jcm.rouge_l(CANDS, REFS, beta=2.0)
    assert pcm.cider_d(CANDS, REFS) == jcm.cider_d(CANDS, REFS)
    assert pcm.spice_lite(CANDS, REFS) == jcm.spice_lite(CANDS, REFS)
    got, want = pcm.get_all_metrics(CANDS, REFS), jcm.get_all_metrics(CANDS, REFS)
    assert got == want and got["cider_d"] > 0 and got["meteor_lite"] > 0


@pytest.mark.parametrize("stages", [("exact",), ("exact", "stem"),
                                    ("exact", "stem", "synonym")])
def test_meteor_and_alignment_equal_jax(stages):
    assert (pcm.meteor(CANDS, REFS, stages=stages)
            == jcm.meteor(CANDS, REFS, stages=stages))
    for cand, refs in zip(CANDS, REFS):
        for ref in refs:
            c, r = cand.split(), ref.split()
            assert (pcm._meteor_align(c, r, stages)
                    == jcm._meteor_align(c, r, stages)), (cand, ref)


def test_stemmer_and_tuples_equal_jax():
    words = WORDS + [w for c in CANDS for w in c.split()]
    assert [pcm._porter_stem(w) for w in words] == [jcm._porter_stem(w) for w in words]
    for text in CANDS + [r for refs in REFS for r in refs]:
        for keep in (False, True):
            assert (pcm._caption_tuples(text, keep_stopwords=keep)
                    == jcm._caption_tuples(text, keep_stopwords=keep)), text


def test_synonym_tables_equal_jax():
    assert psyn._GROUPS == jsyn._GROUPS
    assert psyn.load_groups() == jsyn.load_groups()
    assert psyn.synonym_index() == jsyn.synonym_index()
    groups = (frozenset({"a", "b"}), frozenset({"b", "c"}))
    assert psyn.synonym_index(groups) == jsyn.synonym_index(groups) == {
        "a": [0], "b": [0, 1], "c": [1]}


def test_synonym_json_override(tmp_path, monkeypatch):
    """LLT2I_SYNONYM_JSON replaces the table in the port as in the JAX
    package: the same groups (lower-cased), and METEOR aligns through them."""
    p = tmp_path / "syn.json"
    p.write_text(json.dumps([["Zyx", "wvu"], ["dog", "hound"]]))
    monkeypatch.setenv("LLT2I_SYNONYM_JSON", str(p))
    monkeypatch.setattr(pcm, "_SYN_IDX", None)  # drop the lazy caches
    monkeypatch.setattr(jcm, "_SYN_IDX", None)
    groups = psyn.load_groups()
    assert groups == jsyn.load_groups()
    assert frozenset({"zyx", "wvu"}) in groups and len(groups) == 2
    got = pcm.meteor(["zyx hound"], [["wvu dog"]])
    assert got == jcm.meteor(["zyx hound"], [["wvu dog"]]) and got > 0.4
    # the vendored pair big~large is gone under the override
    assert pcm._meteor_align(["big"], ["large"]) == []
