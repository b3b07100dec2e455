"""PBRT scene files: tokenizer, parser and the loader that builds a
Scene. Mirrors pbrs_tpu/scene/pbrt/."""
