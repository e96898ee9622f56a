"""The port's trainer against the reference's ``build_train_step`` on
``xlstm-1.3b``, ``whisper-tiny`` and ``internvl2-76b``: the check and its
tolerances are ``test_torch_train_families.py``'s (kept in a file of its
own so that each file's run stays short).  Also the mLSTM's chunked
gradient where its masked exponent overflows."""
import numpy as np
import pytest
import torch

from repro_torch.models.xlstm import mlstm_chunked, mlstm_reference
from test_torch_train_families import FAMILIES, HERE, _one_thread, check_family  # noqa: F401


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", [a for a in FAMILIES if a not in HERE])
def test_train_step_matches_jax(arch, k):
    check_family(arch, k)


def test_mlstm_gradient_is_finite_where_the_masked_exponent_overflows():
    """A large input gate late in a chunk makes the intra-chunk exponent
    above the diagonal (a masked entry) overflow fp32.  The forward keeps
    the step oracle's values, and no gradient is NaN: a zero gradient
    times ``exp(inf)`` would be."""
    rng = np.random.default_rng(0)
    B, T, H, Dh = 1, 16, 2, 8
    q, k, v = (torch.tensor(rng.standard_normal((B, T, H, Dh), dtype=np.float32),
                            requires_grad=True) for _ in range(3))
    i_pre = np.zeros((B, T, H), np.float32)
    i_pre[:, 12] = 200.0
    i_pre = torch.tensor(i_pre, requires_grad=True)
    f_pre = torch.tensor(rng.standard_normal((B, T, H), dtype=np.float32),
                         requires_grad=True)
    y = mlstm_chunked(q, k, v, i_pre, f_pre, chunk=16)
    want = mlstm_reference(q.detach(), k.detach(), v.detach(), i_pre.detach(), f_pre.detach())
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    grads = torch.autograd.grad(y.square().sum(), (q, k, v, i_pre, f_pre))
    for name, g in zip(("q", "k", "v", "i_pre", "f_pre"), grads):
        assert torch.isfinite(g).all(), name
