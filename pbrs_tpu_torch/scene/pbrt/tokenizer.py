"""PBRT scene-file tokenizer. A copy of
pbrs_tpu/scene/pbrt/tokenizer.py (host code, no JAX).

Equivalent of the reference's logos-derived lexer
(reference scene_parser/src/token.rs:2-117, lexer.rs:27-59): emits directive
words, quoted strings, numbers and brackets; `Include` files are lexed and
spliced inline (lexer.rs:40-56).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"[^"]*")
  | (?P<lbracket>\[)
  | (?P<rbracket>\])
  | (?P<number>[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?)
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<ws>\s+)
""",
    re.VERBOSE,
)

# Directive words recognized by the parser (a superset of what the loader
# consumes; unknown directives still tokenize as words).
DIRECTIVES = {
    "LookAt", "Camera", "Integrator", "Sampler", "Film", "PixelFilter",
    "Accelerator", "WorldBegin", "WorldEnd", "AttributeBegin", "AttributeEnd",
    "TransformBegin", "TransformEnd", "ObjectBegin", "ObjectEnd",
    "ObjectInstance", "Shape", "Material", "MakeNamedMaterial",
    "NamedMaterial", "Texture", "LightSource", "AreaLightSource",
    "Translate", "Rotate", "Scale", "Transform", "ConcatTransform",
    "CoordinateSystem", "CoordSysTransform", "Identity", "ReverseOrientation",
    "MediumInterface", "MakeNamedMedium", "Include", "Import",
}


@dataclass
class Token:
    kind: str  # 'word' | 'string' | 'number' | 'lbracket' | 'rbracket'
    value: object


def tokenize_string(text: str, root_dir: str = ".") -> list[Token]:
    out: list[Token] = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SyntaxError(
                f"unexpected character {text[pos]!r} at offset {pos}"
            )
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        if kind == "string":
            out.append(Token("string", m.group()[1:-1]))
        elif kind == "number":
            out.append(Token("number", float(m.group())))
        elif kind == "word":
            word = m.group()
            # Include: splice the lexed child file inline.
            # [ref: scene_parser/src/lexer.rs:40-56]
            if word in ("Include", "Import"):
                m2 = _skip_ws_to_string(text, pos)
                if m2 is None:
                    raise SyntaxError("Include without a file name")
                fname, pos = m2
                out.extend(tokenize_file(os.path.join(root_dir, fname)))
            else:
                out.append(Token("word", word))
        else:
            out.append(Token(kind, m.group()))
    return out


def _skip_ws_to_string(text, pos):
    while pos < len(text) and text[pos].isspace():
        pos += 1
    if pos < len(text) and text[pos] == '"':
        end = text.index('"', pos + 1)
        return text[pos + 1:end], end + 1
    return None


def tokenize_file(path: str) -> list[Token]:
    with open(path, "r") as f:
        return tokenize_string(f.read(), root_dir=os.path.dirname(path) or ".")
