"""The binary record writer's batch form (colbwt_tpu_torch/io/pml_out.py
`record_layout`, `fill_records`, `PmlCidBinaryWriter.append_planes`) and
the engines' uint16 planes it is fed (pipeline/engines.py `materialize` of
a `narrow` dispatch): files byte-equal to the per-record writer, to
`write_pml_cid_binary` and to the JAX package's, records in input order,
one block a run of records of one shape."""

import numpy as np
import pytest
import torch

from colbwt_tpu.io import pml_out as JP
from colbwt_tpu_torch.io import pml_out as TP
from colbwt_tpu_torch.pipeline.engines import QueryEngines
from colbwt_tpu_torch.utils.profiling import StepTimer

W = 24


def _packed(rng, B):
    """A u16 packed pml << 8 | cid plane, as K3 returns it."""
    return ((rng.integers(0, 200, (B, W)) << 8)
            | rng.integers(0, 256, (B, W))).astype(np.uint16)


def _runs(names, lens):
    shapes = [(len(n.encode()), int(m)) for n, m in zip(names, lens)]
    return sum(1 for i, s in enumerate(shapes) if i == 0 or s != shapes[i - 1])


def _case(kind, rng):
    """[(names, lens, pml plane, cid plane)] a batch."""
    if kind == "packed_u16":
        names = [f"q{i}" for i in range(5, 130)]  # names grow at 10 and 100
        lens = np.full(len(names), 20)
        lens[-7:] = 21
        pk = _packed(rng, len(names))
        return [(names, lens, pk >> 8, pk & 0xFF)]
    if kind == "int32_out_of_range":
        names = [f"r{i}" for i in range(40)]
        lens = np.full(40, W)
        p = rng.integers(-70000, 140000, (40, W)).astype(np.int32)
        c = rng.integers(-300, 70000, (40, W)).astype(np.int32)
        return [(names, lens, p, c)]
    if kind == "zero_length":
        names = ["a", "b", "c", "d", "e"]
        lens = np.array([0, 0, 3, 0, W])
        pk = _packed(rng, 5)
        return [(names, lens, pk >> 8, pk & 0xFF)]
    if kind == "utf8_names":
        names = ["é1", "e1", "読み", "ab", "ab", "🧬x", "é2"]
        lens = np.full(len(names), 9)
        pk = _packed(rng, len(names))
        return [(names, lens, pk >> 8, pk & 0xFF)]
    if kind == "one_shape":
        names = [f"s{i}" for i in range(10, 90)]
        lens = np.full(len(names), 17)
        pk = _packed(rng, len(names))
        return [(names, lens, pk >> 8, pk & 0xFF)]
    if kind == "every_neighbour_differs":
        names = [("x" * (1 + i % 3)) + str(i % 10) for i in range(60)]
        lens = 5 + (np.arange(60) * 7) % (W - 4)
        p = rng.integers(0, 300, (60, W)).astype(np.int32)
        c = rng.integers(0, 256, (60, W)).astype(np.int32)
        return [(names, lens, p, c)]
    if kind == "several_batches":
        out = []
        for b in range(4):
            names = [f"b{b}r{i}" for i in range(8 + 9 * b)]
            lens = rng.integers(0, W + 1, len(names))
            lens[: len(names) // 2] = W // 2
            pk = _packed(rng, len(names))
            out.append((names, lens, pk >> 8, pk & 0xFF))
        return out
    raise ValueError(kind)


KINDS = ["packed_u16", "int32_out_of_range", "zero_length", "utf8_names",
         "one_shape", "every_neighbour_differs", "several_batches"]


def _rows(plane, lens):
    Wp = plane.shape[1]
    return [plane[j, Wp - int(m):] for j, m in enumerate(lens)]


@pytest.mark.parametrize("kind", KINDS)
def test_plane_form_equals_per_record_writers(tmp_path, kind):
    rng = np.random.default_rng(KINDS.index(kind) + 0x9D)
    batches = _case(kind, rng)
    with TP.PmlCidBinaryWriter(tmp_path / "planes.pml",
                               tmp_path / "planes.cid") as w:
        blocks = []
        for names, lens, p, c in batches:
            layout = TP.record_layout(names, lens)
            blocks.append(layout.blocks)
            w.append_planes(layout, p, c)
        assert w.records == sum(len(b[0]) for b in batches)
    assert blocks == [_runs(n, m) for n, m, _, _ in batches]
    with TP.PmlCidBinaryWriter(tmp_path / "list.pml",
                               tmp_path / "list.cid") as w:
        for names, lens, p, c in batches:
            w.append(names, _rows(p, lens), _rows(c, lens))
    names = [n for b in batches for n in b[0]]
    pmls = [r for b in batches for r in _rows(b[2], b[1])]
    cids = [r for b in batches for r in _rows(b[3], b[1])]
    TP.write_pml_cid_binary(tmp_path / "port.pml", tmp_path / "port.cid",
                            names, pmls, cids)
    JP.write_pml_cid_binary(tmp_path / "jax.pml", tmp_path / "jax.cid",
                            names, pmls, cids)
    for ext in ("pml", "cid"):
        got = (tmp_path / f"planes.{ext}").read_bytes()
        for other in ("list", "port", "jax"):
            assert got == (tmp_path / f"{other}.{ext}").read_bytes(), other
    got_names, got_pml = TP.read_pml_cid_binary(tmp_path / "planes.pml")
    assert got_names == names
    for a, want in zip(got_pml, pmls):
        np.testing.assert_array_equal(a, np.clip(want, 0, 0xFFFF))


@pytest.mark.parametrize("split", ["packed_u16", "packed_int32",
                                   "two_int32"])
def test_narrow_materialize_splices_fallback_rows(tmp_path, split):
    """A narrow dispatch's planes, the fallback rows spliced mid-batch
    clipped as the files store them, write the files the default
    (int32) planes write through the per-record writer."""
    rng = np.random.default_rng(0xFA11)
    B = 30
    names = [f"n{i}" for i in range(B)]
    lens = rng.integers(1, W + 1, B)
    if split == "two_int32":
        p = torch.from_numpy(rng.integers(0, 900, (B, W)).astype(np.int32))
        c = torch.from_numpy(rng.integers(0, 256, (B, W)).astype(np.int32))
    else:
        pk = _packed(rng, B)
        if split == "packed_int32":
            pk = pk.astype(np.int32) | (rng.integers(0, 600, (B, W)) << 16)
        p, c = torch.from_numpy(pk.copy()), None
    idxs = np.array([3, 4, 17])
    p2 = torch.from_numpy(
        rng.integers(-5, 70000, (idxs.size, W)).astype(np.int32))
    c2 = torch.from_numpy(rng.integers(0, 256, (idxs.size, W)).astype(np.int32))

    def result(narrow):
        pp = p.clone()
        cc = None if c is None else c.clone()
        return (pp, cc, lens, (idxs, p2, c2), None, StepTimer(), narrow)

    wp, wc, wl = QueryEngines.materialize(result(False))
    assert wp.dtype == np.int32 and wc.dtype == np.int32
    np_, nc, nl = QueryEngines.materialize(result(True))
    if split == "packed_u16":  # split narrow, fallback rows clipped
        assert np_.dtype == np.uint16 and nc.dtype == np.uint16
        np.testing.assert_array_equal(np_, np.clip(wp, 0, 0xFFFF))
        np.testing.assert_array_equal(nc, np.clip(wc, 0, 0xFFFF))
    else:  # int32 planes pass as they are: fill_records clips them
        np.testing.assert_array_equal(np_, wp)
        np.testing.assert_array_equal(nc, wc)
    with TP.PmlCidBinaryWriter(tmp_path / "a.pml", tmp_path / "a.cid") as w:
        w.append_planes(TP.record_layout(names, nl), np_, nc)
    with TP.PmlCidBinaryWriter(tmp_path / "b.pml", tmp_path / "b.cid") as w:
        w.append(names, _rows(wp, wl), _rows(wc, wl))
    for ext in ("pml", "cid"):
        assert ((tmp_path / f"a.{ext}").read_bytes()
                == (tmp_path / f"b.{ext}").read_bytes())


@pytest.mark.parametrize("bad", ["short_planes", "long_read",
                                 "names_lens"])
def test_plane_form_refuses_mismatched_shapes(bad):
    names = ["a", "b", "c"]
    lens = np.array([2, 3, 4])
    p = np.zeros((3, 4), np.uint16)
    if bad == "short_planes":
        with pytest.raises(ValueError):
            TP.fill_records(TP.record_layout(names, lens), p[:2], p[:2])
    elif bad == "long_read":
        with pytest.raises(ValueError):
            TP.fill_records(TP.record_layout(names, lens + 1), p, p)
    else:
        with pytest.raises(ValueError):
            TP.record_layout(names, lens[:2])
