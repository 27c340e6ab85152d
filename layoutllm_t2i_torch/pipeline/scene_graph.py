"""Relation-triplet extraction from captions (a copy of
layoutllm_t2i_tpu/pipeline/scene_graph.py, pure ``re``: importing it through
the JAX package could load JAX).

The reference calls sng_parser (spaCy scene-graph parser) on the host per
caption (txt2img.py:212-244, trainer_combined_layout.py:334-369). sng_parser
is an optional dependency here; when absent, a rule-based extractor built
for the COCO caption domain approximates its output: noun-phrase chunks over
the token stream, relations from a preposition set plus a caption-domain
verb lexicon (with inflection handling), entity heads reduced to the
sng_parser ``lemma_head`` convention (head noun, singularized, keeping known
COCO compounds like "dining table"). Both paths return triplet strings
"subj rel obj".

Measured on the 943 NSS1K captions (scripts/scene_graph_stats.py; pinned in
tests/test_scene_graph_stats.py): the rule-based extractor yields >=1
triplet on ~96% of the three relation splits (only_spatial / only_semantic /
mix_relation). Expected divergence from sng_parser, documented rather than
hidden: no dependency parse means (1) attachment is linear — the object is
the next NP after the marker, so long clauses can mis-attach; (2) verbs
outside the lexicon are missed; (3) sng_parser also emits triplets for most
"non-relation" captions (possessive "of"/"with" constructs), and so does
this extractor (~90% yield on that split) — the split names classify the
*layout task*, not parser output.

``relation_texts_for_inference`` reproduces the reference inference quirk
(interface.py:220-254, txt2img.py:213-244): the list starts with "PAD", the
triplets are appended TWICE, and when no relation is found the embedding
block stays all-zero (the PAD string itself is never encoded alone).
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

try:  # pragma: no cover - optional dependency
    import sng_parser  # type: ignore

    _HAS_SNG = True
except Exception:
    _HAS_SNG = False

# --------------------------------------------------------------------------
# token classes (caption domain)
# --------------------------------------------------------------------------

_DETS = frozenset(
    "a an the this that these those some many several few"
    " his her its their my our your there here which who whose"
    " what one two three four five six seven eight nine ten eleven twelve"
    " other another each every all both more most much any no".split()
)

_COPULAS = frozenset("is are was were be been being".split())

# multiword prepositions, longest-match-first (sng_parser keeps the full
# phrase as the relation string for these)
_MW_PREPS = (
    "on top of", "on the side of", "on the back of", "in front of",
    "in the middle of", "next to", "attached to", "close to", "out of",
    "off of", "full of", "on side of",
)

_PREPS = frozenset(
    "on in under above below behind near beside with at by over around"
    " inside outside against across along between beneath atop upon of onto"
    " into from to toward towards underneath through during alongside"
    " amongst among for down up past".split()
)

# caption-domain verbs, base form; inflections handled by _verb_base.
_VERBS = frozenset(
    "ride hold wear eat chase watch play carry hit throw catch cut drink"
    " walk fly jump feed pet swing serve surf ski drive pull push look stare"
    " blow lift roam pose hang stand sit lie lean graze fight kiss hug touch"
    " use fix wash clean cook bake grab reach kick point read talk sing"
    " brush climb cross enter pass follow chew lick sniff smell skateboard"
    " snowboard surfboard sail row paddle swim run race land take give show"
    " perform prepare slice pour spread wrap top cover fill surround contain"
    " display attach park place rest float travel approach leave board exit"
    " overlook face share attempt try pitch bat dunk shoot dribble"
    " juggle balance stack pile lay set put hand toss flip grind skate pedal"
    " steer tow haul drag guide herd milk shear groom saddle mount dismount"
    " embrace cuddle nuzzle peck bite gnaw nibble munch devour sip gulp"
    " pour stir whisk knead roll frost decorate garnish celebrate blow"
    " light extinguish wave salute bow kneel squat crouch stretch yawn"
    " sleep nap doze rest wake smile laugh frown cry shout yell speak"
    " whistle hum type write draw paint sketch photograph film record"
    " browse scroll text call dial answer work study teach learn examine"
    " inspect observe admire ponder contemplate lead make dress alter mow"
    " vacuum trim arrange organize overlook line go have".split()
)

# irregular gerund/3sg stems that _verb_base's suffix rules can't recover
_VERB_IRREGULARS = {
    "sitting": "sit", "sits": "sit", "lying": "lie", "lies": "lie",
    "flying": "fly", "flies": "fly", "carrying": "carry", "carries": "carry",
    "hitting": "hit", "hits": "hit", "cutting": "cut", "cuts": "cut",
    "running": "run", "runs": "run", "swimming": "swim", "swims": "swim",
    "grabbing": "grab", "putting": "put", "puts": "put",
    "setting": "set", "sets": "set", "batting": "bat", "bats": "bat",
    "tries": "try", "trying": "try", "studies": "study", "studying": "study",
    "laying": "lay", "lays": "lay", "wrapping": "wrap", "wraps": "wrap",
    "topping": "top", "tops": "top", "filling": "fill",
    "petting": "pet", "pets": "pet", "stirring": "stir", "stirs": "stir",
    "napping": "nap", "naps": "nap", "jogging": "jog", "skiing": "ski",
    "skis": "ski", "canoeing": "canoe",
    # irregular past/participle forms
    "sat": "sit", "stood": "stand", "held": "hold", "wore": "wear",
    "worn": "wear", "ate": "eat", "eaten": "eat", "rode": "ride",
    "ridden": "ride", "hung": "hang", "laid": "lay", "drove": "drive",
    "driven": "drive", "threw": "throw", "thrown": "throw",
    "caught": "catch", "ran": "run", "swam": "swim", "flew": "fly",
    "flown": "fly", "drew": "draw", "drawn": "draw", "took": "take",
    "taken": "take", "gave": "give", "given": "give", "led": "lead",
    "made": "make", "has": "have", "had": "have", "having": "have",
    "went": "go", "going": "go", "gone": "go", "goes": "go",
    "lit": "light", "lain": "lie", "lay": "lie",
}

# COCO-style compound heads kept whole (sng_parser keeps spaCy compounds in
# the entity head: "dining table", "stop sign", ...)
_COMPOUNDS = frozenset(
    (
        "dining table", "fire hydrant", "traffic light", "stop sign",
        "tennis racket", "teddy bear", "hot dog", "cell phone",
        "parking meter", "baseball bat", "baseball glove", "street sign",
        "train station", "wine glass", "sports ball", "hair drier",
        "potted plant", "living room", "tennis court", "baseball field",
        "train track", "train tracks", "fire truck", "police car",
        "street light", "light pole", "power line", "picnic table",
        "coffee table", "side walk", "skate board", "surf board",
        "snow board", "tennis player", "baseball player", "water bath",
        "bath tub", "frisbee",
    )
)

_CLAUSE_SPLIT = re.compile(r"[,.;:!?]| while | as | when | because | so that ")
_WORD = re.compile(r"[a-z]+")


def _verb_base(tok: str) -> Optional[str]:
    """Base verb form if ``tok`` inflects a lexicon verb, else None."""
    if tok in _VERB_IRREGULARS:
        base = _VERB_IRREGULARS[tok]
        return base if base in _VERBS else None
    if tok in _VERBS:
        return tok
    if tok.endswith("ing"):
        stem = tok[:-3]
        for cand in (stem, stem + "e"):
            if cand in _VERBS:
                return cand
    if tok.endswith("es") and tok[:-2] in _VERBS:
        return tok[:-2]
    if tok.endswith("s") and tok[:-1] in _VERBS:
        return tok[:-1]
    if tok.endswith("ed"):
        stem = tok[:-2]
        for cand in (stem, stem + "e",
                     stem[:-1] if stem[-1:] == stem[-2:-1] else stem):
            if cand in _VERBS:
                return cand
    return None


def _singular(tok: str) -> str:
    if len(tok) <= 3 or not tok.endswith("s"):
        return tok
    if tok.endswith(("ss", "us", "is")):
        return tok
    if tok.endswith("ies"):
        return tok[:-3] + "y"
    if tok.endswith(("ches", "shes", "sses", "xes", "zes")):
        return tok[:-2]
    return tok[:-1]


def _head(chunk: Sequence[str]) -> str:
    """sng_parser lemma_head convention: head noun of the chunk,
    singularized; known COCO compounds kept as two words; coordinated
    chunks ("scissors and tape") reduce to the last conjunct's head."""
    toks = list(chunk)
    while toks and toks[-1] in ("and", "or", "but"):
        toks.pop()
    # reciprocal objects survive as-is ("vases sitting next to each other")
    joined = " ".join(toks)
    if joined.endswith(("each other", "one another")):
        return "each other"
    if "and" in toks:
        after = toks[toks.index("and") + 1:]
        before = toks[: toks.index("and")]
        # prefer the last conjunct, but not when it reduces to nothing
        # ("a mountain range and one" -> "range", not "")
        toks = after if _head(after) else before
    toks = [t for t in toks if t not in _DETS and t not in _COPULAS]
    if not toks:
        return ""
    head = _singular(toks[-1])
    if len(toks) >= 2:
        comp = f"{_singular(toks[-2])} {head}"
        comp2 = f"{toks[-2]} {head}"
        if comp in _COMPOUNDS or comp2 in _COMPOUNDS:
            return comp2 if comp2 in _COMPOUNDS else comp
    return head


def _markers(tokens: List[str]) -> List[Tuple[int, int, str, str]]:
    """(start, end, relation_string, kind) spans over the token list,
    longest multiword preps first, then verbs (merged with a trailing
    preposition: "hanging from"), then single preps."""
    out = []
    taken = [False] * len(tokens)
    mw = [p.split() for p in _MW_PREPS]
    for i in range(len(tokens)):
        for words in mw:
            j = i + len(words)
            if tokens[i:j] == words and not any(taken[i:j]):
                out.append((i, j, " ".join(words), "prep"))
                for k in range(i, j):
                    taken[k] = True
                break
    verb_end = -1
    for i, tok in enumerate(tokens):
        if taken[i]:
            continue
        base = _verb_base(tok)
        # a lexicon word directly after a determiner is a noun, not a verb
        # ("a swing", "the watch"); a plural-shaped one directly after a
        # verb is its object, not a second verb ("riding skateboards",
        # "holding bats") — gerunds after verbs stay verbs (participle
        # chains: "standing around staring at ...")
        if base and i == verb_end and tok.endswith("s") and tok != base:
            continue
        if base and (i == 0 or tokens[i - 1] not in _DETS):
            rel, end = tok, i + 1
            while end < len(tokens) and tokens[end] in _PREPS and not taken[end]:
                rel, end = f"{rel} {tokens[end]}", end + 1
            out.append((i, end, rel, "verb"))
            for k in range(i, end):
                taken[k] = True
            verb_end = end
    for i, tok in enumerate(tokens):
        # a preposition directly after a determiner is a noun use ("the
        # inside of the bathroom", "a close up"), same rule as verbs
        if not taken[i] and tok in _PREPS and (
                i == 0 or tokens[i - 1] not in _DETS):
            out.append((i, i + 1, tok, "prep"))
            taken[i] = True
    out.sort()
    # merge adjacent markers ("standing" + "on top of" -> "standing on top
    # of", "inside" + "of"): the first of an adjacent pair always has an
    # empty object chunk and would be dropped, so merging strictly adds
    # yield — and matches sng_parser's verb+prep relation strings
    merged: List[Tuple[int, int, str, str]] = []
    for m in out:
        # only a PREP extends the previous marker — merging two verbs
        # ("holding" + "bats" misread as a verb) would eat the object
        if merged and merged[-1][1] == m[0] and m[3] == "prep":
            s, _, rel, kind = merged[-1]
            merged[-1] = (s, m[1], f"{rel} {m[2]}", kind)
        else:
            merged.append(list(m))  # type: ignore[arg-type]
    return [tuple(m) for m in merged]  # type: ignore[return-value]


def _rule_based_triplets(caption: str) -> List[str]:
    triplets: List[str] = []
    seen = set()
    carry_subj = ""  # trailing NP head of the previous clause: the subject
    # of appositive continuations ("A young man, ..., is posing for the
    # camera" -> man pose for camera)
    for clause in _CLAUSE_SPLIT.split(caption.lower()):
        tokens = _WORD.findall(clause)
        if not tokens:
            continue
        marks = _markers(tokens)
        pending_subj = ""
        for idx, (s, e, rel, kind) in enumerate(marks):
            prev_end = marks[idx - 1][1] if idx else 0
            next_start = marks[idx + 1][0] if idx + 1 < len(marks) else len(tokens)
            subj_chunk = [t for t in tokens[prev_end:s] if t not in _COPULAS]
            obj_chunk = [t for t in tokens[e:next_start] if t not in _COPULAS]
            subj, obj = _head(subj_chunk), _head(obj_chunk)
            if not subj:
                # participle chains share the subject ("bears standing
                # around staring at something" -> bear staring at
                # something); clause-initial markers take the previous
                # clause's NP
                subj = pending_subj or (carry_subj if idx == 0 else "")
            if subj:
                pending_subj = subj
            # subj == obj allowed: sng_parser emits same-lemma triplets
            # ("phone next to phone")
            if not subj or not obj:
                continue
            trip = f"{subj} {rel} {obj}"
            if trip not in seen:
                seen.add(trip)
                triplets.append(trip)
        tail_start = marks[-1][1] if marks else 0
        lead_end = marks[0][0] if marks else len(tokens)
        carry_subj = (_head(tokens[tail_start:])
                      or _head(tokens[:lead_end]) or carry_subj)
    return triplets


def parse_triplets(caption: str) -> List[str]:
    """Returns ["subj rel obj", ...] for a caption."""
    if _HAS_SNG:  # pragma: no cover - depends on optional package
        graph = sng_parser.parse(caption)
        entities = graph["entities"]
        out = []
        for r in graph.get("relations", []):
            obj = entities[r["object"]]["lemma_head"]
            subj = entities[r["subject"]]["lemma_head"]
            out.append(" ".join([subj, r["relation"], obj]))
        return out
    return _rule_based_triplets(caption)


def relation_texts_for_inference(caption: str, max_relas: int = 5) -> Optional[List[str]]:
    """Inference-path relation list with reference parity: ["PAD"] + triplets
    duplicated, truncated to max_relas; None when no relations (-> zero
    embeddings)."""
    triplets = parse_triplets(caption)
    if not triplets:
        return None
    relations = ["PAD"] + triplets + triplets
    return relations[:max_relas]


def relation_texts_for_training(caption: str, max_relas: int = 5) -> List[str]:
    """Trainer-path list: plain triplets, truncated (trainer_combined_layout
    .py:341-361); empty list -> zero embeddings."""
    return parse_triplets(caption)[:max_relas]
