"""Recursive-descent PBRT parser -> AST. A copy of
pbrs_tpu/scene/pbrt/parser.py (host code, no JAX).

[ref: scene_parser/src/parser.rs:14-326, ast.rs:6-123]

Grammar: scene = option* "WorldBegin" world_item* "WorldEnd".
Parameters follow PBRT's `"type name" value-or-[values]` convention and are
collected into a ParameterSet keyed by the full declaration string.

Extensions over the reference parser: `Transform` / `ConcatTransform`
matrices parse into real transforms (the reference leaves them
`unimplemented!`, parser.rs:317-319), and Object blocks parse for real
instancing support.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ParameterSet:
    """Declared parameters: full key ("rgb Kd") -> float | str | list.
    [ref: scene_parser/src/ast.rs:30-88]"""

    params: dict = field(default_factory=dict)

    def extract(self, full_key):
        return self.params.pop(full_key, None)

    def extract_by_name(self, name):
        """Match by the declared *name* regardless of type word (the
        reference's extract_substr, ast.rs:58-69). Returns (key, value)."""
        for key in list(self.params):
            words = key.split()
            if (len(words) >= 2 and words[1] == name) or key == name:
                return key, self.params.pop(key)
        return None

    def number(self, name, default=None):
        hit = self.extract_by_name(name)
        if hit is None:
            return default
        _, v = hit
        if isinstance(v, list):
            return float(v[0])
        return float(v)

    def string(self, name, default=None):
        hit = self.extract_by_name(name)
        if hit is None:
            return default
        _, v = hit
        if isinstance(v, list) and v and isinstance(v[0], str):
            v = v[0]  # pbrt allows bracketed string values: ["foo.png"]
        return v if isinstance(v, str) else default

    def numbers(self, name, default=None):
        hit = self.extract_by_name(name)
        if hit is None:
            return default
        _, v = hit
        if isinstance(v, list):
            return [float(x) for x in v]
        return [float(v)]

    def spectrum(self, name):
        """(spectrum_type, numbers-or-string) or None."""
        hit = self.extract_by_name(name)
        if hit is None:
            return None
        key, v = hit
        stype = key.split()[0] if " " in key else "rgb"
        return stype, v

    def boolean(self, name, default=None):
        hit = self.extract_by_name(name)
        if hit is None:
            return default
        _, v = hit
        return str(v).lower() == "true"


# AST node constructors are plain tuples: (tag, ...).


class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    # -- token helpers --
    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise SyntaxError("unexpected end of scene file")
        self.i += 1
        return t

    def expect_word(self, word):
        t = self.next()
        if t.kind != "word" or t.value != word:
            raise SyntaxError(f"expected {word}, got {t.kind}:{t.value}")

    def next_string(self):
        t = self.next()
        if t.kind != "string":
            raise SyntaxError(f"expected string, got {t.kind}:{t.value}")
        return t.value

    def next_number(self):
        t = self.next()
        if t.kind != "number":
            raise SyntaxError(f"expected number, got {t.kind}:{t.value}")
        return t.value

    def next_numbers(self, count):
        return [self.next_number() for _ in range(count)]

    # -- parameters: sequence of "type name" value-or-[values] --
    # [ref: scene_parser/src/parser.rs:223-271]
    def parse_params(self) -> ParameterSet:
        ps = ParameterSet()
        while True:
            t = self.peek()
            if t is None or t.kind != "string":
                return ps
            key = self.next().value
            nxt = self.peek()
            if nxt is None:
                raise SyntaxError(f"parameter {key} without a value")
            if nxt.kind == "lbracket":
                self.next()
                values = []
                while self.peek() and self.peek().kind != "rbracket":
                    values.append(self.next().value)
                self.next()  # ]
                ps.params[key] = values
            else:
                ps.params[key] = self.next().value

    # -- transforms -- [ref: scene_parser/src/parser.rs:273-326]
    def parse_transform_directive(self, word):
        if word == "LookAt":
            nums = self.next_numbers(9)
            return ("lookat", nums[0:3], nums[3:6], nums[6:9])
        if word == "Translate":
            return ("translate", self.next_numbers(3))
        if word == "Scale":
            return ("scale", self.next_numbers(3))
        if word == "Rotate":
            nums = self.next_numbers(4)
            return ("rotate", nums[0], nums[1:4])
        if word in ("Transform", "ConcatTransform"):
            t = self.peek()
            if t and t.kind == "lbracket":
                self.next()
                nums = []
                while self.peek() and self.peek().kind != "rbracket":
                    nums.append(self.next_number())
                self.next()
            else:
                nums = self.next_numbers(16)
            tag = "set_matrix" if word == "Transform" else "concat_matrix"
            return (tag, nums)
        if word == "Identity":
            return ("identity",)
        if word in ("CoordinateSystem", "CoordSysTransform"):
            return ("coordsys", word, self.next_string())
        raise SyntaxError(f"not a transform: {word}")

    TRANSFORM_WORDS = {
        "LookAt", "Translate", "Rotate", "Scale", "Transform",
        "ConcatTransform", "Identity", "CoordinateSystem", "CoordSysTransform",
    }

    # -- scene-wide options -- [ref: parser.rs:177-221]
    def parse_scene_options(self):
        options = []
        while True:
            t = self.peek()
            if t is None:
                raise SyntaxError("missing WorldBegin")
            if t.kind == "word" and t.value == "WorldBegin":
                return options
            word = self.next().value
            if word in self.TRANSFORM_WORDS:
                options.append(("transform", self.parse_transform_directive(word)))
            elif word in ("Camera", "Integrator", "Sampler", "Film",
                          "PixelFilter", "Accelerator"):
                impl = self.next_string()
                options.append((word.lower(), impl, self.parse_params()))
            elif word == "MakeNamedMedium":
                self.next_string()
                self.parse_params()
            else:
                raise SyntaxError(f"unknown scene-wide option {word}")

    # -- world items -- [ref: parser.rs:41-163]
    def parse_world_items(self, terminators):
        items = []
        while True:
            t = self.peek()
            if t is None:
                raise SyntaxError(f"missing one of {terminators}")
            if t.kind == "word" and t.value in terminators:
                return items
            word = self.next().value
            if word in self.TRANSFORM_WORDS:
                items.append(("transform", self.parse_transform_directive(word)))
            elif word == "Shape":
                items.append(("shape", self.next_string(), self.parse_params()))
            elif word == "Material":
                items.append(("material", self.next_string(), self.parse_params()))
            elif word == "MakeNamedMaterial":
                items.append(
                    ("make_material", self.next_string(), self.parse_params())
                )
            elif word == "NamedMaterial":
                items.append(("named_material", self.next_string()))
            elif word == "Texture":
                name = self.next_string()
                tex_type = self.next_string()
                tex_impl = self.next_string()
                items.append(("texture", name, tex_type, tex_impl,
                              self.parse_params()))
            elif word == "LightSource":
                items.append(("light", self.next_string(), self.parse_params()))
            elif word == "AreaLightSource":
                items.append(
                    ("arealight", self.next_string(), self.parse_params())
                )
            elif word == "AttributeBegin":
                children = self.parse_world_items({"AttributeEnd"})
                self.expect_word("AttributeEnd")
                items.append(("attribute", children))
            elif word == "TransformBegin":
                children = self.parse_world_items({"TransformEnd"})
                self.expect_word("TransformEnd")
                items.append(("transform_block", children))
            elif word == "ObjectBegin":
                name = self.next_string()
                children = self.parse_world_items({"ObjectEnd"})
                self.expect_word("ObjectEnd")
                items.append(("object", name, children))
            elif word == "ObjectInstance":
                items.append(("object_instance", self.next_string()))
            elif word == "ReverseOrientation":
                items.append(("reverse_orientation",))
            elif word == "MediumInterface":
                # two string operands, ignored
                self.next_string()
                if self.peek() and self.peek().kind == "string":
                    self.next_string()
            else:
                raise SyntaxError(f"unknown world item {word}")

    def parse_scene(self):
        options = self.parse_scene_options()
        self.expect_word("WorldBegin")
        items = self.parse_world_items({"WorldEnd"})
        t = self.peek()
        if t and t.kind == "word" and t.value == "WorldEnd":
            self.next()
        return options, items


def parse_tokens(tokens):
    return Parser(tokens).parse_scene()
