"""The serving engine's device handling, on the card.

Imports neither ``jax`` nor the JAX package; run on a machine with an
H100 as ``test_torch_paged_attention_cuda.py`` is run. Skips elsewhere.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve import Engine, EngineOptions


@pytest.mark.cuda
def test_engine_takes_params_made_on_its_device():
    """Params made on ``"cuda"`` lie on ``cuda:<index>``; the engine's
    default device must compare equal to it, and the kernel path is
    picked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config("moe-gpt3-s").reduced()
    params = lm.init(cfg, 0, device="cuda")
    engine = Engine(cfg, params, options=EngineOptions(
        page_size=4, max_slots=2, max_seq_len=32, chunk=16))
    assert engine.device == params["final_norm"]["scale"].device
    req = engine.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    engine.run_until_idle()
    assert len(req.output) == 4
    assert engine.stats()["attn_kernel"] == "kernel"
