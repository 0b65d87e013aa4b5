"""The frozen cost arithmetic against counts made by hand."""
import pytest

from fedbench import costs


def test_rates_are_the_data_sheet_s():
    assert costs.HBM_BYTES_PER_S == 3.35e12
    assert costs.FP32_FLOPS_PER_S == 67e12
    assert costs.BF16_FLOPS_PER_S == 989e12
    assert costs.SFU_PER_S == 16 * 132 * 1.98e9


def test_bound_takes_the_larger_term():
    assert costs.bound(3.35e9, 0.0) == pytest.approx(1.0)      # 1 ms
    assert costs.bound(0.0, 67e9) == pytest.approx(1.0)
    assert costs.bound(3.35e9, 134e9) == pytest.approx(2.0)
    assert costs.bound(0.0, 989e9, costs.BF16_FLOPS_PER_S) == \
        pytest.approx(1.0)


def test_gather_work_by_hand():
    # K=10 windows of 400 rows of 784 float32, read and written, plus
    # labels (read, written), the mask and two [K] int vectors
    flops, nbytes = costs.gather_work(10, 400, 784)
    assert flops == 0
    assert nbytes == 2 * 10 * 400 * 784 * 4 + 3 * 10 * 400 * 4 + 2 * 10 * 4
    assert nbytes == 25_136_080


def test_mclr_sgd_work_by_hand():
    flops, nbytes = costs.mclr_sgd_work(100, 10, 400, 784, 26, 10, 960)
    assert flops == 100 * (4 * 10 * 784 * 26 + 2 * 784 * 26 + 8 * 10 * 26)
    x, y, idx = 10 * 400 * 784 * 4, 10 * 400 * 4, 10 * 960 * 10 * 4
    params = (784 * 26 + 26) * 4
    out = 10 * (784 * 26 + 26 + 1) * 4
    assert nbytes == x + y + idx + params + 2 * 10 * 4 + out
    assert costs.mclr_model_flops(100, 10, 784, 26) == 100 * 815_360


def test_scan_bwd_work_by_hand():
    nbytes, flops, exps = costs.scan_bwd_work(1, 2048, 8192, 16)
    BSd, BSN, dN, BdN = 2048 * 8192, 2048 * 16, 8192 * 16, 8192 * 16
    assert nbytes == 4 * (5 * BSd + 4 * BSN + 2 * dN + 3 * BdN)
    assert flops == 19 * BSd * 16 + 4 * BSd
    assert exps == BSd * 16
    # at this length the bytes bound it: 339 MB at 3.35 TB/s
    assert costs.scan_bound(nbytes, flops, exps) == pytest.approx(
        nbytes / costs.HBM_BYTES_PER_S * 1e3)


def test_xent_bwd_work_by_hand():
    flops, nbytes = costs.xent_bwd_work(1024, 4096, 65024)
    assert flops == 3 * 2 * 1024 * 4096 * 65024
    assert nbytes == 2 * 2 * (1024 * 4096 + 4096 * 65024) + 12 * 1024


def test_lm_train_flops_is_six_n_d():
    assert costs.lm_train_flops(3.9e9, 2048) == 6 * 3.9e9 * 2048
