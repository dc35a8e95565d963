"""Text normalisation for VQA questions and answers (the port's copy of
``vqa_attention_networks_tpu/data/text.py``; numpy-free and torch-free, kept
here so that the port imports nothing of the JAX package).

The reference's normalisation pass (reference ``utils.py:60-109``):
lowercase every word, canonicalise English contractions, and map number
words to digits. The contraction table is the standard VQA-evaluation
table, quirks included (``tests/test_text.py`` pins them). Tokenisation is
the reference's ``\\w+`` regex (``utils.py:174,189``).
"""

from __future__ import annotations

import re
from typing import Dict, List

_WORD_RE = re.compile(r"\w+")

# word -> canonical contraction. Includes the upstream VQA-eval idiosyncrasies
# the reference inherits (e.g. "somebody'd" -> "somebodyd" is reversed in the
# original table; preserved for parity with utils.py:69).
CONTRACTIONS: Dict[str, str] = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't",
    "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've", "itll": "it'll",
    "let's": "let's",
    "maam": "ma'am",
    "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've",
    "neednt": "needn't", "notve": "not've",
    "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't",
    "shed've": "she'd've", "she'dve": "she'd've", "she's": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someoned've": "someone'd've",
    "someone'dve": "someone'd've", "someonell": "someone'll",
    "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's",
    "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas",
    "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
    "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've",
    "youd": "you'd", "youd've": "you'd've", "you'dve": "you'd've",
    "youll": "you'll", "youre": "you're", "youve": "you've",
}

# number words -> digit strings (utils.py:82-94)
NUMBER_WORDS: Dict[str, str] = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}


def normalize_words(words: List[str]) -> List[str]:
    """Lowercase, contract and digit-map each word (utils.py:96-109).

    Order matters and matches the reference: lowercase first, then the
    contraction table, then the number map. Note the reference looks up the
    *lowercased* word in a table whose few capitalised keys ("Im", "I'dve")
    are therefore unreachable — same here, by construction.
    """
    out = []
    for w in words:
        w = w.lower()
        w = CONTRACTIONS.get(w, w)
        w = NUMBER_WORDS.get(w, w)
        out.append(w)
    return out


def normalize_answer(answer: str) -> str:
    """Normalise a single answer string the way the reference normalises
    answers (``contract_word([ans])[0]``, utils.py:180-181)."""
    return normalize_words([answer])[0]


def tokenize(sentence: str) -> List[str]:
    """Regex word tokenizer + normalisation (utils.py:174,189-190)."""
    return normalize_words(_WORD_RE.findall(sentence))


def encode_question(
    sentence: str,
    question_vocab: Dict[str, int],
    max_len: int,
    right_align: bool = False,
) -> List[int]:
    """Encode a question into padded token ids.

    Left-aligned zero-padded ids as in training prep (utils.py:185-196);
    ``right_align=True`` reproduces the predict CLI's alignment
    (predict_pytorch.py:61-66). OOV words map to the UNK id.
    """
    words = tokenize(sentence)[:max_len]
    unk = question_vocab["UNK"]
    ids = [question_vocab.get(w, unk) for w in words]
    pad = [0] * (max_len - len(ids))
    return pad + ids if right_align else ids + pad
