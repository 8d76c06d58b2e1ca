"""S4 (the first frame's BCE): two steps of the port's AVS make_train_step
against the JAX package's, and the first step's gradients, on the tiny AVS
model (tolerances in tests/avs_train_parity.py)."""
import pytest

from avs_train_parity import few_threads, jax_steps, make_model, port_steps_match_jax


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    yield from few_threads()


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture(scope="module")
def jax_run(model):
    return jax_steps(model, "s4")


def test_s4_train_steps_match_jax(model, jax_run):
    """Loss, new state and params after each step, the first step's
    gradients; the frozen leaves never take requires_grad."""
    port_steps_match_jax(model, jax_run, "s4")
