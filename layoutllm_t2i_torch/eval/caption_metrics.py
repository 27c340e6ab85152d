"""Caption-overlap metrics: BLEU-1..4, ROUGE-L, CIDEr-D, METEOR, SPICE-lite
(a copy of layoutllm_t2i_tpu/eval/caption_metrics.py: host-only Python, so
the port keeps its own copy and imports nothing of the JAX package).

Reference capability: GLIGEN/clip_score.py get_all_metrics (via
pycocoevalcap). Re-implemented from the metric definitions in pure Python.
METEOR runs the exact + Porter-stem + synonym matcher stages (synonyms from
the vendored caption-domain synset table in eval/synonyms.py, or a real
WordNet export via LLT2I_SYNONYM_JSON); only the Java release's paraphrase
table is unavailable offline. SPICE is scored as tuple-F1 over the port's
copy of the scene-graph parser (pipeline/scene_graph.py), "spice_lite".

Inputs are pre-tokenized lowercase strings; candidates: list[str],
references: list[list[str]].
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(candidates: List[str], references: List[List[str]], max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with the standard brevity penalty."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        c = cand.lower().split()
        rs = [r.lower().split() for r in refs]
        cand_len += len(c)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            cg = _ngrams(c, n)
            max_ref = Counter()
            for r in rs:
                rg = _ngrams(r, n)
                for g, cnt in rg.items():
                    max_ref[g] = max(max_ref[g], cnt)
            clipped[n - 1] += sum(min(cnt, max_ref[g]) for g, cnt in cg.items())
            totals[n - 1] += max(sum(cg.values()), 0)
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    scores = []
    log_sum = 0.0
    for n in range(max_n):
        p = clipped[n] / totals[n] if totals[n] else 0.0
        log_sum += math.log(p) if p > 0 else -9e9
        scores.append(bp * math.exp(log_sum / (n + 1)))
    return scores


def _lcs_len(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(candidates: List[str], references: List[List[str]],
            beta: float = 1.2) -> float:
    """Mean ROUGE-L F-beta over examples (max over references)."""
    scores = []
    for cand, refs in zip(candidates, references):
        c = cand.lower().split()
        best = 0.0
        for ref in refs:
            r = ref.lower().split()
            lcs = _lcs_len(c, r)
            if lcs == 0:
                continue
            prec = lcs / len(c)
            rec = lcs / len(r)
            f = (1 + beta ** 2) * prec * rec / (rec + beta ** 2 * prec)
            best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


def cider_d(candidates: List[str], references: List[List[str]], max_n: int = 4,
            sigma: float = 6.0) -> float:
    """CIDEr-D: tf-idf weighted n-gram cosine with length gaussian penalty."""
    # document frequency over reference sets
    df: Dict[tuple, int] = defaultdict(int)
    ref_grams = []
    for refs in references:
        seen = set()
        per_ref = []
        for ref in refs:
            toks = ref.lower().split()
            grams = [_ngrams(toks, n) for n in range(1, max_n + 1)]
            per_ref.append((toks, grams))
            for g in grams:
                seen.update(g.keys())
        ref_grams.append(per_ref)
        for g in seen:
            df[g] += 1
    n_docs = max(len(references), 1)

    def tfidf_vec(grams: Counter, length: int):
        vec = {}
        norm = 0.0
        for g, cnt in grams.items():
            idf = math.log(max(n_docs, 1)) - math.log(max(df[g], 1))
            w = (cnt / max(length, 1)) * idf if length else 0.0
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for cand, per_ref in zip(candidates, ref_grams):
        c = cand.lower().split()
        c_grams = [_ngrams(c, n) for n in range(1, max_n + 1)]
        score_n = [0.0] * max_n
        for r_toks, r_grams in per_ref:
            delta = len(c) - len(r_toks)
            penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
            for n in range(max_n):
                cv, cn = tfidf_vec(c_grams[n], len(c))
                rv, rn = tfidf_vec(r_grams[n], len(r_toks))
                dot = sum(min(cv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g in cv)
                if cn > 0 and rn > 0:
                    score_n[n] += penalty * dot / (cn * rn)
        k = max(len(per_ref), 1)
        scores.append(10.0 * sum(s / k for s in score_n) / max_n)
    return sum(scores) / max(len(scores), 1)


def get_all_metrics(candidates: List[str], references: List[List[str]]) -> Dict[str, float]:
    b = bleu(candidates, references)
    return {
        "bleu1": b[0], "bleu2": b[1], "bleu3": b[2], "bleu4": b[3],
        "rouge_l": rouge_l(candidates, references),
        "cider_d": cider_d(candidates, references),
        # "_lite" keys: approximations of the Java-dependency metrics — this
        # METEOR implements only the exact+Porter-stem matcher stages (no
        # WordNet/paraphrase tables); numbers are NOT comparable to
        # pycocoevalcap's. See README eval section.
        "meteor_lite": meteor(candidates, references),
        "spice_lite": spice_lite(candidates, references),
    }


# ---------------------------------------------------------------------------
# METEOR (exact + Porter-stem matching stages)
#
# The reference reaches METEOR through pycocoevalcap's Java jar
# (clip_score.py:243-263), which adds WordNet-synonym and paraphrase-table
# stages; those tables are external models unavailable offline, so this is
# the standard METEOR formulation (alpha=0.9, beta=3, gamma=0.5) with the
# exact and stem modules only — documented as such.


def _porter_stem(word: str) -> str:
    """Compact Porter stemmer (the published 1980 algorithm, steps 1a-5b)."""
    if len(word) <= 2:
        return word
    w = word.lower()

    vowels = "aeiou"

    def is_cons(s, i):
        c = s[i]
        if c in vowels:
            return False
        if c == "y":
            return i == 0 or not is_cons(s, i - 1)
        return True

    def measure(s):
        form = "".join("c" if is_cons(s, i) else "v" for i in range(len(s)))
        return form.count("vc", 0, len(form)) if "vc" not in form else sum(
            1 for i in range(len(form) - 1) if form[i] == "v" and form[i + 1] == "c")

    def has_vowel(s):
        return any(not is_cons(s, i) for i in range(len(s)))

    def ends_double_cons(s):
        return len(s) >= 2 and s[-1] == s[-2] and is_cons(s, len(s) - 1)

    def cvc(s):
        return (len(s) >= 3 and is_cons(s, len(s) - 3)
                and not is_cons(s, len(s) - 2) and is_cons(s, len(s) - 1)
                and s[-1] not in "wxy")

    # step 1a
    for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
        if w.endswith(suf):
            w = w[: len(w) - len(suf)] + rep
            break
    # step 1b
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    elif (w.endswith("ed") and has_vowel(w[:-2])) or \
         (w.endswith("ing") and has_vowel(w[:-3])):
        w = w[:-2] if w.endswith("ed") else w[:-3]
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif measure(w) == 1 and cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2/3 (suffix map, m > 0)
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble"), ("icate", "ic"),
                     ("ative", ""), ("alize", "al"), ("iciti", "ic"),
                     ("ical", "ic"), ("ful", ""), ("ness", "")):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if measure(stem) > 0:
                w = stem + rep
            break
    # step 4 (m > 1)
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                "ive", "ize"):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and measure(w[:-3]) > 1 and w[-4] in "st":
            w = w[:-3]
    # step 5
    if w.endswith("e"):
        stem = w[:-1]
        if measure(stem) > 1 or (measure(stem) == 1 and not cvc(stem)):
            w = stem
    if ends_double_cons(w) and w.endswith("l") and measure(w) > 1:
        w = w[:-1]
    return w


def _synonym_keys():
    """Lazy word -> frozenset(group ids) lookup for the synonym stage
    (vendored caption-domain synset table, eval/synonyms.py; swap in a real
    WordNet export via LLT2I_SYNONYM_JSON)."""
    global _SYN_IDX
    if _SYN_IDX is None:
        from .synonyms import synonym_index

        _SYN_IDX = {w: frozenset(g) for w, g in synonym_index().items()}
    return _SYN_IDX


_SYN_IDX = None


def _meteor_align(cand: List[str], ref: List[str],
                  stages: tuple = ("exact", "stem", "synonym")):
    """Greedy staged alignment (exact, stem, synonym — the Java METEOR's
    stage order, with the paraphrase-table stage unavailable offline);
    returns matched index pairs (ci, ri)."""
    matched_c = [False] * len(cand)
    matched_r = [False] * len(ref)
    pairs = []

    def run_stage(match):
        for ci, tok in enumerate(cand):
            if matched_c[ci]:
                continue
            for ri, rtok in enumerate(ref):
                if not matched_r[ri] and match(tok, rtok):
                    matched_c[ci] = matched_r[ri] = True
                    pairs.append((ci, ri))
                    break

    for stage in stages:
        if stage == "exact":
            run_stage(lambda a, b: a == b)
        elif stage == "stem":
            run_stage(lambda a, b: _porter_stem(a) == _porter_stem(b))
        elif stage == "synonym":
            idx = _synonym_keys()
            empty = frozenset()
            run_stage(lambda a, b: bool(
                idx.get(a, empty) & idx.get(b, empty)))
        else:  # pragma: no cover - guarded upstream
            raise ValueError(f"unknown meteor stage: {stage}")
    return sorted(pairs)


def meteor(candidates: List[str], references: List[List[str]],
           alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5,
           stages: tuple = ("exact", "stem", "synonym")) -> float:
    """Corpus METEOR (mean of sentence scores, best reference per sentence).

    Matcher stages follow the Java METEOR order: exact, Porter-stem,
    synonym (vendored synset table / LLT2I_SYNONYM_JSON); the paraphrase
    stage needs the Java release's table and stays unavailable — its
    headroom is measured by scripts/caption_metric_bounds.py."""
    scores = []
    for cand, refs in zip(candidates, references):
        c = cand.lower().split()
        best = 0.0
        for ref in refs:
            r = ref.lower().split()
            pairs = _meteor_align(c, r, stages)
            m = len(pairs)
            if m == 0 or not c or not r:
                continue
            precision = m / len(c)
            recall = m / len(r)
            fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
            # chunks: maximal runs contiguous in both strings
            chunks = 1
            for (c0, r0), (c1, r1) in zip(pairs, pairs[1:]):
                if c1 != c0 + 1 or r1 != r0 + 1:
                    chunks += 1
            penalty = gamma * (chunks / m) ** beta
            best = max(best, fmean * (1 - penalty))
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# SPICE-lite: F1 over scene-graph tuples
#
# The reference's SPICE uses a Java dependency-parse pipeline
# (clip_score.py:243-263). This variant extracts (entity,), and
# (subj, rel, obj) tuples with the same scene-graph parser the relation
# conditioning uses (pipeline/scene_graph.py) and scores tuple F1 — the SPICE
# definition over a lighter parser, labeled spice_lite. Java SPICE's tuples
# are content words only (a dependency parse never emits 'the' as an
# object), so the unigram stage drops function words; measured divergence
# of the unfiltered variant is +0.12 on NSS1K pairs (scripts/spice_bound.py).

_SPICE_STOPWORDS = frozenset(
    "the and are was were with that this them they there then than has had "
    "have his her its our your own one two few all any some each both very "
    "not but for nor out off too who whom whose what when where which while "
    "into onto over under above below from near next".split())


def _caption_tuples(caption: str, keep_stopwords: bool = False):
    from ..pipeline.scene_graph import parse_triplets

    tokens = caption.lower().split()
    tuples = {(t,) for t in tokens
              if len(t) > 2 and (keep_stopwords or t not in _SPICE_STOPWORDS)}
    for trip in parse_triplets(caption):
        tuples.add(tuple(trip.split()))
    return tuples


def spice_lite(candidates: List[str], references: List[List[str]]) -> float:
    scores = []
    for cand, refs in zip(candidates, references):
        ct = _caption_tuples(cand)
        rt = set()
        for ref in refs:
            rt |= _caption_tuples(ref)
        if not ct or not rt:
            scores.append(0.0)
            continue
        inter = len(ct & rt)
        p = inter / len(ct)
        r = inter / len(rt)
        scores.append(0.0 if p + r == 0 else 2 * p * r / (p + r))
    return sum(scores) / max(len(scores), 1)
