"""Context parallelism of the port through the pipeline: pp 2 x sep 2
under the four schedules (the ring refused under 1F1B and ZB-H1) and
pp 2 x mp 2 x sep 2 over 8 ranks, gloo ranks on the CPU, against the
JAX single-device
eager model on the same weights (``torch_cp_oracle``), each rank on its
slice of the sequence.

Tolerances: f32 losses ``rtol=1e-5`` at the first step and ``1e-4``
after AdamW steps (the pipeline tests'), SGD losses ``rtol=1e-4``;
first-step gradients ``rtol=1e-4, atol=1e-6``, final weights
``rtol=atol=1e-4``.
"""

from __future__ import annotations

import pytest
import torch

from torch_cp_oracle import check_arrays, check_losses, pipe_run
from torch_cp_oracle import pools  # noqa: F401  (the fixture)

torch.set_num_threads(1)


# ---- pp x sep (4 ranks) -----------------------------------------------------

@pytest.mark.parametrize("schedule,V,impl", [
    ("FThenB", None, "ring"), ("interleaved", 2, "ring"),
    ("1F1B", None, "ulysses"), ("ZB-H1", None, "ulysses"),
    ("1F1B", None, "allgather"), ("ZB-H1", None, "allgather")])
def test_pp2_sep2_matches_the_jax_run(pools, schedule, V, impl):
    """pp 2 x sep 2 over 4 ranks, 2 microbatches of each rank's slice of
    the sequence (the JAX package's matrix: the ring under the scan
    schedules, Ulysses and all-gather under 1F1B and ZB-H1): losses, the
    first step's gradients gathered over the stages and the final
    weights against the JAX run."""
    fields = {"num_hidden_layers": 4, "scan_layers": False,
              "sep_parallel": impl}
    pipe_run(pools, 4, fields, {"pp_degree": 2, "sep_degree": 2,
                                 "dp_degree": 1}, schedule, V)


def test_pp2_sep2_sgd_under_1f1b(pools):
    """SGD at lr 0.1 through pp 2 x sep 2 under 1F1B with Ulysses (the JAX
    package's sensitivity test): a sep-scaled gradient would move the
    second loss far outside the tolerance."""
    fields = {"num_hidden_layers": 4, "sep_parallel": "ulysses"}
    pipe_run(pools, 4, fields, {"pp_degree": 2, "sep_degree": 2,
                                 "dp_degree": 1}, "1F1B", opt_name="sgd",
              lr=0.1)


def test_ring_is_refused_under_1f1b_and_zb_h1(pools):
    """Ring context parallelism under the explicit schedules raises
    ``ValueError`` naming the ring, as in the JAX package; the scan
    schedules take it."""
    for res in pools(4).run("torch_cp_cases:pipe_ring_refused",
                            ["1F1B", "ZB-H1", "FThenB"]):
        for schedule in ("1F1B", "ZB-H1"):
            assert res[schedule][0] == "ValueError"
            assert "ring" in res[schedule][1]
        assert res["FThenB"] is None


# ---- 8 ranks --------------------------------------------------------------------------

def test_pp2_mp2_sep2_over_8_ranks(pools):
    """pp 2 x mp 2 x sep 2 over 8 ranks (``tests/test_pipeline_parallel.py:
    474``'s hybrid, without sequence parallelism, which the port's pipe
    models refuse): FThenB with the ring over each stage's sep pair, the
    layers split over the model group; losses, first gradients and
    weights against the JAX run."""
    fields = {"num_hidden_layers": 4, "scan_layers": False,
              "sep_parallel": "ring"}
    pipe_run(pools, 8, fields, {"pp_degree": 2, "mp_degree": 2,
                                 "sep_degree": 2, "dp_degree": 1}, "FThenB")
