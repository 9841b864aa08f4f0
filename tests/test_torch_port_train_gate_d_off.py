"""The port's FA-VAE train step against `favae_tpu.train.favae_step` on the
CPU, D off: BatchNorm statistics only (bounds and set-up in tests/favae_train_common.py)."""

import pytest

from tests.favae_train_common import f32_torch, run_gates  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("gates", [
    ((False, True), (False, False)),
])
def test_train_steps_match_jax(gates):
    run_gates(gates)
