"""Vendored synonym table for meteor's synonym stage (a copy of
layoutllm_t2i_tpu/eval/synonyms.py: host-only, so the port keeps its own
copy and imports nothing of the JAX package).

The reference METEOR (pycocoevalcap's Java jar, GLIGEN/clip_score.py:243-263)
matches through WordNet synsets. WordNet's data files are not in the
repository, so this module vendors a hand-curated caption-domain synset
table: each entry is a set of words that share a WordNet synset, restricted
to vocabulary that occurs in COCO-style captions. Groups may overlap (a
word can sit in several synsets, e.g. "bike" with both "bicycle" and
"motorcycle"), exactly like WordNet.

Fidelity hook: point LLT2I_SYNONYM_JSON at a JSON file of word-groups
(list[list[str]]), e.g. one exported from a real WordNet installation, and
it replaces this table, making the synonym stage full-fidelity.
"""
from __future__ import annotations

import json
import os
from typing import Dict, FrozenSet, List, Tuple

_GROUPS: Tuple[Tuple[str, ...], ...] = (
    # people
    ("man", "guy", "fellow", "gentleman", "dude", "bloke"),
    ("woman", "lady", "gal"),
    ("person", "individual", "someone", "somebody"),
    ("people", "folks", "persons"),
    ("child", "kid", "youngster", "tyke"),
    ("boy", "lad"),
    ("girl", "lass"),
    ("baby", "infant", "babe"),
    ("teen", "teenager", "adolescent"),
    ("crowd", "throng"),
    ("player", "participant"),
    ("police", "cops"), ("cop", "officer", "policeman"),
    # animals
    ("dog", "canine"), ("puppy", "pup"),
    ("cat", "feline"), ("kitten", "kitty"),
    ("bird", "fowl"), ("cow", "bovine"), ("cattle", "cows", "kine"),
    ("horse", "equine", "steed"), ("pony", "colt"),
    ("sheep", "lamb"), ("pig", "hog", "swine"),
    ("rabbit", "bunny", "hare"), ("monkey", "ape", "primate"),
    # vehicles
    ("bicycle", "bike", "cycle"),
    ("motorcycle", "motorbike", "bike"),
    ("car", "auto", "automobile"),
    ("truck", "lorry"), ("taxi", "cab", "taxicab"),
    ("bus", "coach", "omnibus"),
    ("plane", "airplane", "aircraft", "aeroplane", "jet"),
    ("boat", "vessel", "watercraft"), ("ship", "vessel"),
    ("train", "railcar", "locomotive"),
    ("trolley", "streetcar", "tram"),
    # scenes / places
    ("photo", "photograph", "picture", "image", "shot", "snapshot", "pic"),
    ("street", "road", "roadway"), ("highway", "freeway", "motorway"),
    ("sidewalk", "pavement", "walkway"),
    ("store", "shop"), ("market", "marketplace"),
    ("house", "home", "dwelling", "residence"),
    ("restroom", "bathroom", "lavatory", "toilet", "washroom"),
    ("kitchen", "cookhouse"), ("couch", "sofa", "lounge"),
    ("rug", "carpet"), ("curtain", "drape"),
    ("closet", "wardrobe", "cupboard"),
    ("garbage", "trash", "rubbish", "refuse", "waste"),
    ("ocean", "sea"), ("woods", "forest", "wood"),
    ("meadow", "field", "pasture"), ("hill", "mound"),
    ("rock", "stone"), ("beach", "shore", "seashore", "coast"),
    ("yard", "lawn"), ("fence", "fencing"),
    ("building", "edifice", "structure"),
    ("station", "depot", "terminal"),
    # objects
    ("tv", "television", "telly"),
    ("phone", "telephone"), ("cellphone", "mobile", "cell"),
    ("computer", "pc"), ("laptop", "notebook"),
    ("sack", "bag"), ("purse", "handbag", "bag"),
    ("luggage", "baggage"), ("suitcase", "bag", "case"),
    ("plate", "dish"), ("cup", "mug"), ("glass", "tumbler"),
    ("pot", "kettle"), ("pan", "skillet"),
    ("knife", "blade"), ("scissors", "shears"),
    ("lamp", "light"), ("mirror", "looking-glass"),
    ("pillow", "cushion"), ("blanket", "cover", "quilt"),
    ("umbrella", "parasol", "brolly"),
    ("hat", "cap", "lid"), ("eyeglasses", "glasses", "specs", "spectacles"),
    ("tie", "necktie"), ("pants", "trousers", "slacks"),
    ("shirt", "top"), ("jacket", "coat"), ("shoes", "footwear"),
    ("racket", "racquet"), ("ball", "globe", "orb"),
    ("skateboard", "board"), ("surfboard", "board"),
    ("frisbee", "disc", "disk"),
    ("doughnut", "donut"), ("hotdog", "frank", "frankfurter", "wiener"),
    ("hamburger", "burger"), ("sandwich", "sub", "hoagie"),
    ("soda", "pop", "soft-drink"), ("drink", "beverage"),
    ("food", "fare", "grub"), ("meal", "repast"),
    ("dessert", "sweet", "afters"), ("candy", "sweets"),
    ("sign", "signpost", "placard"), ("banner", "streamer"),
    ("clock", "timepiece"), ("watch", "timepiece", "wristwatch"),
    ("vase", "urn"), ("bowl", "basin"),
    ("bottle", "flask"), ("jar", "container"),
    ("box", "carton", "container"), ("basket", "hamper"),
    ("toy", "plaything"), ("doll", "dolly"),
    ("book", "volume"), ("magazine", "mag"),
    ("table", "desk"), ("chair", "seat"), ("bench", "seat", "pew"),
    ("bed", "cot"), ("crib", "cradle"),
    # actions (verb lemmas as they surface after stemming)
    ("ride", "mount"), ("hold", "grasp", "grip", "clutch"),
    ("carry", "tote", "lug"), ("eat", "consume", "devour"),
    ("drink", "sip", "imbibe"), ("throw", "toss", "hurl", "fling"),
    ("catch", "grab", "snag"), ("jump", "leap", "bound", "spring"),
    ("run", "sprint", "dash"), ("walk", "stroll", "amble"),
    ("look", "glance", "peer"), ("watch", "observe", "view"),
    ("talk", "speak", "chat", "converse"),
    ("smile", "grin"), ("laugh", "chuckle", "giggle"),
    ("cut", "slice", "chop"), ("cook", "prepare", "fix"),
    ("begin", "start", "commence"), ("end", "finish", "conclude"),
    ("sleep", "slumber", "doze", "nap"),
    ("sit", "perch"), ("stand", "rise"),
    ("fly", "soar", "glide"), ("fall", "drop", "tumble"),
    ("push", "shove"), ("pull", "tug", "drag", "haul"),
    ("fight", "battle", "combat"), ("play", "frolic", "romp"),
    ("wave", "gesture"), ("wear", "don", "sport"),
    ("repair", "fix", "mend"), ("clean", "wash", "scrub"),
    ("close", "shut"), ("open", "unfold"),
    # attributes
    ("big", "large", "huge", "enormous", "giant", "immense"),
    ("small", "little", "tiny", "miniature", "petite"),
    ("fast", "quick", "speedy", "rapid", "swift"),
    ("slow", "sluggish", "unhurried"),
    ("happy", "glad", "joyful", "cheerful"),
    ("sad", "unhappy", "sorrowful"),
    ("pretty", "beautiful", "lovely", "attractive", "gorgeous"),
    ("ugly", "hideous", "unsightly"),
    ("old", "aged", "elderly"), ("new", "fresh", "novel"),
    ("young", "youthful", "junior"),
    ("clean", "spotless", "tidy"), ("dirty", "filthy", "grimy", "soiled"),
    ("empty", "vacant", "bare"), ("full", "filled", "packed"),
    ("wet", "damp", "moist", "soaked"), ("dry", "arid", "parched"),
    ("cold", "chilly", "frigid"), ("hot", "scorching", "sweltering"),
    ("bright", "brilliant", "vivid"), ("dark", "dim", "gloomy"),
    ("tall", "high", "lofty"), ("short", "low"),
    ("wide", "broad"), ("narrow", "slim", "thin"),
    ("near", "close", "nearby"), ("far", "distant", "remote"),
    ("many", "numerous", "several"), ("few", "scant"),
    ("colorful", "vibrant", "multicolored"),
    ("crowded", "packed", "congested"),
    ("busy", "bustling", "hectic"), ("quiet", "calm", "still", "tranquil"),
    # spatial / misc
    ("under", "beneath", "below", "underneath"),
    ("above", "over", "atop"),
    ("middle", "center", "centre", "midst"),
    ("top", "summit", "peak"), ("bottom", "base", "underside"),
    ("side", "flank"), ("edge", "rim", "border", "margin"),
    ("front", "fore"), ("back", "rear"),
    ("group", "bunch", "cluster", "clump"),
    ("pile", "heap", "stack", "mound"),
    ("pair", "couple", "duo", "twosome"),
    ("row", "line"), ("corner", "nook"),
)


def load_groups() -> Tuple[FrozenSet[str], ...]:
    """The active synonym groups: LLT2I_SYNONYM_JSON if set, else the
    vendored caption-domain table."""
    path = os.environ.get("LLT2I_SYNONYM_JSON")
    if path:
        with open(path) as f:
            return tuple(frozenset(w.lower() for w in g) for g in json.load(f))
    return tuple(frozenset(g) for g in _GROUPS)


def synonym_index(groups=None) -> Dict[str, List[int]]:
    """word -> list of group ids it belongs to (a word can sit in several
    synsets, like WordNet)."""
    idx: Dict[str, List[int]] = {}
    for gi, group in enumerate(groups if groups is not None else load_groups()):
        for w in group:
            idx.setdefault(w, []).append(gi)
    return idx
