"""bench.py's peak table: the H100 row from NVIDIA's data sheet, and an
unknown device is an error rather than a default."""

import pytest

import bench


def test_h100_peak_row():
    p = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert p == {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
                 "f32_tflops": 67.0, "hbm_gbps": 3350.0}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks(kind)
