"""The benchmark's tests' tiny root over every traffic kind: `tiny.make_root`
knows the first three kinds only, so `tests/tiny_kinds.make_root` (the same
root, every kind retargeted) takes its place for every test under
`benchmark/`."""

from benchmark.tests import tiny, tiny_kinds

tiny.make_root = tiny_kinds.make_root
