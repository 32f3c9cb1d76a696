"""Compact engine: the PyTorch port against the JAX package.

Both packages get the same index arrays and the same reads, made from a
seed with numpy; the port runs its plain PyTorch path on the CPU.  Every
compared value is an integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_xla as JX
from colbwt_tpu_torch.models.tensors import index_tensors, to_device
from colbwt_tpu_torch.ops import query_xla as TX
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0x71A4)
    base = bytes(rng.choice(list(b"ACGT"), 220).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, unsplit = build_index(docs)
    split = ColPmlIndex.build(tbl, ff_bound=2)
    reads = make_reads(rng, docs, 24) + [b"NNNNNNN", b"ACGTNACGT", b"A"]
    return tbl, unsplit, split, reads


def test_index_tensors_match_jax(case):
    _, index, _, _ = case
    got = index_tensors(index, CPU)
    want = JX.index_device_arrays(index)
    assert set(got) == set(want)
    for name, arr in want.items():
        g = got[name]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(arr), err_msg=name)


@pytest.mark.parametrize("which", ["unsplit", "split", "split-unbounded"])
def test_query_batch_device_matches_jax(case, which):
    """ff_bound 0 on the unsplit index; on ColPmlIndex.build(tbl,
    ff_bound=2) both its recorded bound and the unbounded loop."""
    _, unsplit, split, reads = case
    index = unsplit if which == "unsplit" else split
    ff = index.ff_bound if which == "split" else 0
    assert (ff >= 2) == (which == "split")
    enc, lens = index.encode_patterns(reads, 64)
    wp, wc = JX.query_batch_device(JX.index_device_arrays(index),
                                   jnp.asarray(enc), jnp.asarray(lens),
                                   ff_bound=ff)
    gp, gc = TX.query_batch_device(index_tensors(index, CPU),
                                   to_device(enc, CPU), to_device(lens, CPU),
                                   ff_bound=ff)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_uint8_patterns_equal_int32(case):
    _, index, _, reads = case
    enc, lens = index.encode_patterns(reads, 64)
    tb = index_tensors(index, CPU)
    a = TX.query_batch_device(tb, to_device(enc, CPU), to_device(lens, CPU))
    b = TX.query_batch_device(tb, to_device(enc, CPU, np.uint8),
                              to_device(lens, CPU))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_query_batch_matches_jax_and_oracle(case):
    tbl, _, split, reads = case
    wp, wc = JX.query_batch(split, reads, max_len=64)
    gp, gc = TX.query_batch(split, reads, max_len=64, device=CPU)
    for read, a, b, c, d in zip(reads, gp, wp, gc, wc):
        np.testing.assert_array_equal(a, b, err_msg=repr(read))
        np.testing.assert_array_equal(c, d, err_msg=repr(read))
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(a, ep)
        np.testing.assert_array_equal(c, ec)
