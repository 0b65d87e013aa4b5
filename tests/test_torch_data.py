"""Port data layer: the generators and ``packed()`` are bitwise the
reference's numpy arrays (the port keeps its own copy of the generators)."""
import numpy as np
import pytest
import torch

from repro.data import federated as ref_fed
from repro_torch.data import federated as port_fed
from torch_cases import one_torch_thread  # noqa: F401

SMALL = {
    "mnist": dict(n_clients=12, total=600, dim=16, max_size=80),
    "femnist": dict(n_clients=10, total=500, dim=16, max_size=60),
    "synthetic": dict(n_clients=8, total=400, dim=12, max_size=90),
    "sent140": dict(n_clients=8, total=300, vocab=300, seq_len=9,
                    max_size=50),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_generators_bitwise(name):
    kw = SMALL[name]
    a = ref_fed.DATASETS[name](seed=3, **kw)
    b = port_fed.DATASETS[name](seed=3, **kw)
    assert (a.name, a.n_classes, a.task) == (b.name, b.n_classes, b.task)
    assert a.n_clients == b.n_clients
    for xa, xb in zip(a.clients_x, b.clients_x):
        assert xa.dtype == xb.dtype
        np.testing.assert_array_equal(xa, xb)
    for ya, yb in zip(a.clients_y, b.clients_y):
        np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(a.test_x, b.test_x)
    np.testing.assert_array_equal(a.test_y, b.test_y)
    np.testing.assert_array_equal(a.sizes, b.sizes)


def test_power_law_sizes_bitwise():
    a = ref_fed.power_law_sizes(np.random.default_rng(5), 50, 4000,
                                max_size=200)
    b = port_fed.power_law_sizes(np.random.default_rng(5), 50, 4000,
                                 max_size=200)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,max_n", [("femnist", None), ("femnist", 30),
                                        ("sent140", None)])
def test_packed_bitwise(name, max_n):
    kw = SMALL[name]
    a = ref_fed.DATASETS[name](**kw).packed(max_n)
    b = port_fed.DATASETS[name](**kw).packed(max_n, device="cpu")
    assert a.max_n == b.max_n
    for fa, fb in ((a.x, b.x), (a.y, b.y), (a.offsets, b.offsets),
                   (a.lengths, b.lengths)):
        fa = np.asarray(fa)
        assert fb.device.type == "cpu"
        assert str(fa.dtype) == str(fb.dtype).replace("torch.", "")
        np.testing.assert_array_equal(fa, fb.numpy())
    # max_n zero rows of tail slack, int32 offsets/lengths
    assert b.offsets.dtype == torch.int32 and b.lengths.dtype == torch.int32
    assert b.x.shape[0] == int(b.lengths.sum()) + b.max_n
    assert not b.x[-b.max_n:].any()


def test_packed_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = port_fed.make_femnist_like(**SMALL["femnist"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.packed()
