"""The PyTorch port's training step on 2 space ranks (gloo, CPU) with the
packed decoder, against the JAX package's one-device step and the port's
one-process step (tests/test_torch_space_step.py has the fine float32
cases and the helpers).

At 32³ and batch 2, packed from tower 3, FG_BG with the phase loss
(factor 64) on triangles voxelized in the step: the decoder shards from
tower 4, where a rank's slab is one packed cell deep, as deep as the
packed convolutions' halos, and towers 4–6 run sharded on packed cells.
Held as the fine float32 cases: loss and statistics within 1e-4 of JAX
and the gradients by the step levels, within 1e-5 of the port's one
process, every rank alike. (At 64³, packed from tower 2, batch 1, the
ranks lie within 1e-5 of one process too, but the port's one-process
step is itself 5.7 % from JAX's in decoder.stage_5_bn1.bias, past the
5 % level next to the loss; batch 2 there passes and takes the file past
three minutes on one worker.)
"""

import pytest
import torch

from test_torch_space_step import (
    assert_matches_one_process, assert_ranks_agree, rank0_model,
    run_cases, run_one_process)

torch.set_num_threads(2)

PACKED_RES = (32, 32, 32)
PACK_FROM_STAGE = 3


@pytest.fixture(scope="module")
def inputs():
  from corenet_tpu_torch.models.convert import state_dict_from_jax
  from test_torch_model import _variables
  from test_torch_train_step import VOX_KWARGS, _triangle_batch
  variables = _variables(PACKED_RES[0])
  cases = {
      "packed": {"res": PACKED_RES, "channels": 2,
                   "model": {"phase_output": True, "packed_decoder": True,
                             "pack_from_stage": PACK_FROM_STAGE},
                   "task": "FG_BG", "vox_kwargs": VOX_KWARGS,
                   "batches": [_triangle_batch()],
                   "state_dict": dict(state_dict_from_jax(variables))},
  }
  return variables, cases


@pytest.fixture(scope="module")
def space2(tmp_path_factory, inputs):
  return run_cases(tmp_path_factory, "space2", inputs[1], world=2, space=2)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, inputs):
  return run_one_process(tmp_path_factory, "one_process", inputs[1])


def test_packed_space_step_matches_jax_and_one_process(inputs, space2,
                                                       one_process):
  from corenet_tpu.models.corenet import CoreNet as JaxCoreNet
  from corenet_tpu.models.corenet import CoreNetConfig as JaxCoreNetConfig
  from corenet_tpu.models.corenet import DecoderConfig as JaxDecoderConfig
  import test_torch_train_step
  from test_torch_space_step import _State
  variables, cases = inputs
  case = cases["packed"]
  got = [r["packed"] for r in space2]
  assert_ranks_agree(got, 2)
  assert got[0]["shard_stage"] == 4
  assert_matches_one_process(one_process[0]["packed"], got[0])
  jax_model = JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=PACKED_RES, num_output_channels=2)), phase_output=True,
                         packed_decoder=True,
                         pack_from_stage=PACK_FROM_STAGE)
  ref = test_torch_train_step._jax_step(
      variables, case["batches"][0], jax_model, case["vox_kwargs"])
  test_torch_train_step._assert_step_matches(
      ref, rank0_model(case, got[0]), _State(got[0]["global_step"]),
      {"loss": got[0]["losses"][0]})
