"""The port's GF(2^8) tables and matrices (seaweedfs_tpu_torch/ops/gf8.py)
equal the JAX package's. K1's own tables are checked against the field in
tests/test_torch_k1_model.py."""

import numpy as np
import pytest

from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu_torch.ops import gf8

GEOMETRIES = [(10, 4), (14, 2), (4, 2), (5, 3)]


def test_field_tables_equal():
    for name in ("GF_EXP", "GF_LOG", "GF_MUL"):
        np.testing.assert_array_equal(getattr(gf8, name),
                                      getattr(ref_gf8, name), err_msg=name)


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_encode_matrix_equal(d, p):
    np.testing.assert_array_equal(gf8.encode_matrix(d, p),
                                  ref_gf8.encode_matrix(d, p))
    np.testing.assert_array_equal(gf8.parity_matrix(d, p),
                                  ref_gf8.parity_matrix(d, p))


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_decode_matrix_equal(d, p):
    rng = np.random.default_rng(d * 100 + p)
    for _ in range(3):
        lost = set(rng.choice(d + p, size=p, replace=False).tolist())
        present = [i for i in range(d + p) if i not in lost]
        np.testing.assert_array_equal(gf8.decode_matrix(d, p, present),
                                      ref_gf8.decode_matrix(d, p, present))


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_expand_to_bits_equal(d, p):
    mat = gf8.parity_matrix(d, p)
    np.testing.assert_array_equal(gf8.expand_to_bits(mat),
                                  ref_gf8.expand_to_bits(mat))
