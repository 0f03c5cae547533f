"""Attribute-derived text prompts for zero-shot ReID (a copy of
tpu_reid/data/attributes.py).

Parses the Market-1501 attribute annotations (`market_attribute.mat`) and
renders one (or 56) natural-language sentences per identity, mirroring the
reference's mapping (reference: data_prepare.py:287-537):

  * the .mat struct holds 27 positional attribute rows — 10 semantic
    attributes (age, backpack, bag, handbag, lower-clothing type,
    lower-length, sleeve, hair, hat, gender), 8 one-vs-rest upper-body
    colors, 9 lower-body colors — plus the identity list as the final row
    (data_prepare.py:297-316),
  * binary attributes decode as value==1 -> first word / else second
    (data_prepare.py:318-335),
  * colors pick the FIRST row whose value != 1, falling back to "other"
    (data_prepare.py:338-347),
  * `get_prompts` renders a single comma-joined sentence per identity
    (data_prepare.py:357-380); `get_prompts_augmented` renders 8 phrasing
    variants x 7 CLIP sentence templates = 56 prompts
    (data_prepare.py:455-527); `get_prompts_simple` renders the 7 generic
    templates with "person no.{i}" (data_prepare.py:287-294).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy import io as sio

SENTENCE_TEMPLATES = (
    "itap of a {}",
    "a bad photo of the {}",
    "a origami {}",
    "a photo of the large {}",
    "a {} in a video game",
    "art of the {}",
    "a photo of the small {}",
)

UPPER_COLORS = ("black", "white", "red", "purple", "yellow", "gray", "blue",
                "green")
LOWER_COLORS = ("black", "white", "pink", "purple", "yellow", "gray", "blue",
                "green", "brown")

AGE_NAMES = {1: "young", 2: "teenager", 3: "adult"}  # else "old"


def load_market_attributes(path: str, split: int = 0):
    """Return (identity_list, attrs (10, N), upper (8, N), lower (9, N)).

    split selects the sub-struct the reference indexes with mat[0][0][0]
    (data_prepare.py:299-300) — the first field of the market_attribute
    struct (index 0); pass 1 for the other split."""
    mat = sio.loadmat(path)["market_attribute"][0][0]
    mat = mat[split][0][0]

    def scalar(x):
        while isinstance(x, np.ndarray):
            x = x.item() if x.size == 1 else x[0]
        return x

    identities = [scalar(x) for x in np.asarray(mat[-1][0]).ravel()]
    attrs = np.stack([np.asarray(mat[i][0]).ravel() for i in range(10)])
    upper = np.stack([np.asarray(mat[i][0]).ravel() for i in range(10, 18)])
    lower = np.stack([np.asarray(mat[i][0]).ravel() for i in range(18, 27)])
    return identities, attrs, upper, lower


def _first_color(column: np.ndarray, names) -> str:
    for i, v in enumerate(column):
        if v != 1:
            return names[i]
    return "other"


def _decode(attrs, upper, lower, index) -> Dict[str, str]:
    # row order in the .mat: age, backpack, bag, handbag, lower-clothing,
    # lower-length, sleeve, hair, hat, gender (data_prepare.py:384-388).
    age, backpack, bag, handbag, clothes, down, sleeve, hair, hat, gender = (
        attrs[:, index]
    )
    return {
        "age": AGE_NAMES.get(int(age), "old"),
        "gender": "male" if gender == 1 else "female",
        "hair": "short hair" if hair == 1 else "long hair",
        "sleeve": "long sleeve" if sleeve == 1 else "short sleeve",
        "length": "long" if down == 1 else "short",
        "clothing": "dress" if clothes == 1 else "pants",
        "color_up": _first_color(upper[:, index], UPPER_COLORS),
        "color_down": _first_color(lower[:, index], LOWER_COLORS),
        "hat": int(hat),
        "backpack": int(backpack),
        "bag": int(bag),
        "handbag": int(handbag),
    }


def get_prompts(path: str) -> Tuple[List[str], Dict[str, str]]:
    """One sentence per identity (reference: data_prepare.py:297-389)."""
    identities, attrs, upper, lower = load_market_attributes(path)
    out = {}
    for index, ident in enumerate(identities):
        a = _decode(attrs, upper, lower, index)
        basic = (
            f"a {a['age']} {a['gender']} person no.{index} with {a['hair']}, "
            f"{a['color_up']} {a['sleeve']}, {a['color_down']} {a['length']} "
            f"{a['clothing']}, "
        )
        hat = "" if a["hat"] == 1 else "wearing a hat, "
        carried = [
            name
            for name, v in (
                ("a backpack", a["backpack"]),
                ("a bag", a["bag"]),
                ("a handbag", a["handbag"]),
            )
            if v != 1
        ]
        if carried:
            advanced = "carrying " + ", ".join(carried)
        else:
            advanced = ""
            hat = hat.rstrip(", ")
        out[ident] = basic + hat + advanced + "."
    return identities, out


def get_prompts_augmented(path: str) -> Tuple[List[str], Dict[str, List[str]]]:
    """56 prompts per identity: 8 phrasing variants x 7 sentence templates
    (reference: data_prepare.py:392-537)."""
    identities, attrs, upper, lower = load_market_attributes(path)
    motions = (
        "on my left or right side with",
        "walking with",
        "rushing with",
        "in the distance with",
    )
    out = {}
    for index, ident in enumerate(identities):
        a = _decode(attrs, upper, lower, index)
        basics = [
            f"{a['age']} {a['gender']} person no.{index} {m} {a['hair']}, "
            f"{a['color_up']} {a['sleeve']}, {a['color_down']} {a['length']} "
            f"{a['clothing']}"
            for m in motions
        ]
        hat = "wearing nothing on head" if a["hat"] == 1 else "wearing a hat"
        carried = [
            name
            for name, v in (
                ("a backpack", a["backpack"]),
                ("a bag", a["bag"]),
                ("a handbag", a["handbag"]),
            )
            if v != 1
        ]
        if carried:
            if len(carried) > 1:
                items = " and ".join([", ".join(carried[:-1]), carried[-1]])
            else:
                items = carried[0]
            advanced = "carrying " + items
        else:
            advanced = "carrying nothing"
        variants = [", ".join((b, hat, advanced)) for b in basics] + [
            ", ".join((b, advanced, hat)) for b in basics
        ]
        out[ident] = [
            st.format(v) for st in SENTENCE_TEMPLATES for v in variants
        ]
    return identities, out


def get_prompts_simple(
    identity_list: List[str], num_class: int
) -> Tuple[List[str], Dict[str, List[str]]]:
    """Generic templates with 'person no.{i}' (data_prepare.py:287-294)."""
    return identity_list, {
        ident: [st.format(f"person no.{i}") for st in SENTENCE_TEMPLATES]
        for i, ident in enumerate(identity_list[:num_class])
    }
