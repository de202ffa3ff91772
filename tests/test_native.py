"""Native (C++) runtime I/O vs the pure-Python fallbacks.

The two backends must be behaviorally identical: same parse of every
deck/table (including the grammar quirks) and byte-identical CSV output.
"""

import os

import numpy as np
import pytest

from conftest import reference_deck

from radiative_transfer import native
from radiative_transfer.config import config as config_mod
from radiative_transfer.utils import io as io_mod

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native librtio.so not built"
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALL_DECKS = [
    reference_deck(n)
    for n in (
        "default.prm",
        "single_group.prm",
        "multi_group_equilibrium.prm",
        "llnl_slab_test.prm",
        "template.prm",
    )
] + [
    os.path.join(REPO, "prm", n)
    for n in (
        "default.prm",
        "single_group.prm",
        "multi_group_equilibrium.prm",
        "llnl_slab_test.prm",
        "template.prm",
    )
]


@pytest.mark.parametrize("deck", ALL_DECKS, ids=lambda p: "/".join(p.split("/")[-2:]))
def test_deck_parse_matches_python(deck):
    py = config_mod.PrmFile(deck, prefer_native=False).params
    nat = native.parse_deck_dict(deck)
    assert nat == py


def test_parse_quirks(tmp_path):
    """First-wins duplicates, '#' only at column 0, value untrimmed, CRLF."""
    p = tmp_path / "q.prm"
    p.write_bytes(
        b"a=1\r\na=2\n # not a comment but has no '='? no: x=9\n"
        b"#comment=skip\nb=  spaced value # tail\nnoequals\nc=\n"
    )
    py = config_mod.PrmFile(str(p), prefer_native=False).params
    nat = native.parse_deck_dict(str(p))
    assert nat == py
    assert py["a"] == "1"
    assert py["b"] == "  spaced value # tail"
    assert py["c"] == ""
    # first '=' wins, even mid-text: key is everything before it
    assert " # not a comment but has no '" in py


def test_table_read_matches_python(tmp_path):
    ref = reference_deck("llnl_slab_test_group_bounds.txt")
    np.testing.assert_array_equal(
        native.read_table(ref), config_mod._read_table(ref, prefer_native=False)
    )
    # stop-at-bad-token semantics
    p = tmp_path / "t.txt"
    p.write_text("1.5 2e3\n  -4.25 nope 7\n")
    a = native.read_table(str(p))
    b = config_mod._read_table(str(p), prefer_native=False)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, [1.5, 2000.0, -4.25])


def _py_writer_bytes(tmp_path, fn, name, *args):
    """Run an io_mod writer with the native backend masked off."""
    path = str(tmp_path / name)
    orig = io_mod._native
    io_mod._native = lambda: None
    try:
        fn(path, *args)
    finally:
        io_mod._native = orig
    with open(path, "rb") as fh:
        return fh.read()


def test_writers_byte_identical(tmp_path):
    rng = np.random.default_rng(7)
    vec = rng.standard_normal(257) * 10.0 ** rng.integers(-12, 12, 257)
    mat = rng.standard_normal((5, 33)) * 10.0 ** rng.integers(-9, 9, (5, 33))
    psi = rng.standard_normal((4, 3, 17))
    for special in (0.0, -0.0, 1e-300, 1e300, 123456789.123456789):
        vec[int(abs(special) % 200)] = special

    cases = [
        (io_mod.write_vector, native.write_vector, "v.csv", vec),
        (io_mod.write_matrix, native.write_matrix, "m.csv", mat),
        (io_mod.write_psi, native.write_psi, "p.csv", psi),
    ]
    for py_fn, nat_fn, name, data in cases:
        py_bytes = _py_writer_bytes(tmp_path, py_fn, "py_" + name, data)
        nat_path = str(tmp_path / ("nat_" + name))
        nat_fn(nat_path, data)
        with open(nat_path, "rb") as fh:
            nat_bytes = fh.read()
        assert nat_bytes == py_bytes, name


def test_load_config_same_through_both_backends(monkeypatch):
    import dataclasses

    deck = reference_deck("llnl_slab_test.prm")
    a = config_mod.load_config(deck)
    monkeypatch.setattr(native, "available", lambda: False)
    b = config_mod.load_config(deck)
    for f in dataclasses.fields(a):
        assert getattr(a, f.name) == getattr(b, f.name), f.name


def test_tokenizer_edge_cases_agree(tmp_path):
    """Hex floats, underscore digit groups, and lone-CR line endings must
    behave identically across backends (and like the reference's
    stream >> double)."""
    t = tmp_path / "edge.txt"
    t.write_text("1.5 0x1C 7\n")
    a = native.read_table(str(t))
    b = config_mod._read_table(str(t), prefer_native=False)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, [1.5])

    t.write_text("2.5 1_000 9\n")
    a = native.read_table(str(t))
    b = config_mod._read_table(str(t), prefer_native=False)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, [2.5])

    d = tmp_path / "cr.prm"
    d.write_bytes(b"a=1\rb=2\r\nc=3\n")
    py = config_mod.PrmFile(str(d), prefer_native=False).params
    nat = native.parse_deck_dict(str(d))
    assert nat == py == {"a": "1", "b": "2", "c": "3"}
