"""The port's TPC-H oracle (``repro_torch.tpch.oracle``, pure numpy) is the
reference's: for each of the 22 queries at SF 0.002 it returns the same
columns with the same dtypes and the same arrays, exactly."""

import functools

import numpy as np
import pytest

from repro.tpch import dbgen as ref_dbgen
from repro.tpch import oracle as ref_oracle
from repro_torch.tpch import dbgen, oracle

SF = 0.002


@functools.lru_cache(maxsize=1)
def data():
    return ref_dbgen.generate(sf=SF)


def test_same_queries():
    assert sorted(oracle.ORACLES) == sorted(ref_oracle.ORACLES) \
        == list(range(1, 23))


def test_port_generator_gives_the_reference_tables():
    """The oracle runs on the port's own ``dbgen.generate`` output on the
    card: the same tables as the reference's, array for array."""
    ours, theirs = dbgen.generate(sf=SF), data()
    assert sorted(ours) == sorted(theirs)
    for t in theirs:
        assert sorted(ours[t]) == sorted(theirs[t]), t
        for c in theirs[t]:
            np.testing.assert_array_equal(ours[t][c], theirs[t][c],
                                          err_msg=f"{t}.{c}")


@pytest.mark.parametrize("q", range(1, 23))
def test_oracle_equals_reference(q):
    got, want = oracle.ORACLES[q](data()), ref_oracle.ORACLES[q](data())
    assert list(got) == list(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype and g.shape == w.shape, c
        np.testing.assert_array_equal(g, w, err_msg=f"q{q}.{c}")
