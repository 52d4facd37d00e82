"""The PyTorch port's data parallelism over processes
(corenet_tpu_torch/parallel/) against the JAX package on the whole batch,
on the CPU.

Ranks are real processes: `run_ranks` starts one Python process per rank,
each with one thread, joined by torch.distributed over gloo through a file
store under the test's temporary directory (no port to clash under
xdist), and every wait on them has a timeout, so a deadlock fails the
test instead of hanging the suite. A rank runs a job function of a test
module, which imports no JAX at its top for that reason, on its slice of
inputs the test made from a seed; the JAX package computes the reference
in the test's own process, in one process on the concatenated batch: the
semantics the JAX package's own multi-process tests assert
(tests/test_multiprocess.py).

Here: BatchRenorm in train mode, 2 ranks × 1 scene against JAX's layer
on 2 scenes (float32 within 1e-5 relative, bf16 by the 2·d rule of
tests/test_torch_bf16.py, phase_packing 8 both ways); the SEMANTIC loss,
whose product of two batch means differs from the mean of the ranks'
products; the confusion reduce and the gather of summary tiles; the
refusals (unequal batches, a missing card, no environment, --space 2 in
a world of 1);
the launcher's retry policy and utils/ui.py against the JAX package's.
The step is in tests/test_torch_distributed_step.py, the pipelines and
the CLI in tests/test_torch_distributed_pipeline.py.
"""

import logging
import os
import pickle
import re
import subprocess
import sys
import textwrap

import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu_torch.parallel import mesh
from corenet_tpu_torch.utils import tracing

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 2

_WORKER = textwrap.dedent("""
    import importlib, os, pickle, sys
    import torch
    torch.set_num_threads(1)
    sys.path[:0] = [{repo!r}, {tests!r}]
    from corenet_tpu_torch.parallel import mesh
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, module, job, inputs, out = sys.argv[3:8]
    if store != "-":  # else the job joins the group itself
      mesh.initialize(init_method="file://" + store, rank=rank,
                      world_size=world, device="cpu")
    with open(inputs, "rb") as f:
      kwargs = pickle.load(f)
    result = getattr(importlib.import_module(module), job)(
        rank, world, **kwargs)
    with open(out, "wb") as f:
      pickle.dump(result, f)
    mesh.barrier("done")
    mesh.shutdown()
""")


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def run_ranks(tmp_path, module, job, inputs=None, world=WORLD, timeout=300,
              env=None, join=True):
  """Runs `module.job(rank, world, **inputs)` in `world` processes and
  returns their results in rank order. With `join` each process first
  joins a gloo group of `world` ranks through a file store; `env` adds
  variables per rank (a function of the rank). The pickles that carry the
  inputs and results are removed once read."""
  tmp = str(tmp_path)
  inputs_path = os.path.join(tmp, f"{job}_inputs.pkl")
  with open(inputs_path, "wb") as f:
    pickle.dump(inputs or {}, f)
  store = os.path.join(tmp, f"{job}_store") if join else "-"
  script = _WORKER.format(repo=REPO, tests=TESTS)
  procs, outs = [], []
  for rank in range(world):
    out = os.path.join(tmp, f"{job}_rank{rank}.pkl")
    outs.append(out)
    penv = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")
    penv.update(env(rank) if env else {})
    procs.append(subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(world), store, module,
         job, inputs_path, out],
        env=penv, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
  logs = []
  try:
    for p in procs:
      logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
  except subprocess.TimeoutExpired:
    for p in procs:
      p.kill()
    logs += [p.communicate()[0].decode(errors="replace") for p in procs]
    raise AssertionError(f"{job}: the ranks did not finish within "
                         f"{timeout} s:\n" + "\n".join(logs))
  for rank, (p, log) in enumerate(zip(procs, logs)):
    assert p.returncode == 0, f"{job} rank {rank} failed:\n{log}"
  results = []
  for out in outs:
    with open(out, "rb") as f:
      results.append(pickle.load(f))
  for path in outs + [inputs_path]:
    os.unlink(path)
  return results


# ---------------------------------------------------------------- ranks ----
def _to_first(x):
  """Channel-last numpy → the port's channel-first tensor."""
  return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _to_last(y):
  return np.moveaxis(y.detach().float().numpy(), 1, -1)


def _renorm_on_rank(rank, case):
  """One BatchRenorm case on this rank's scene: output, input gradient,
  the parameters' gradients (this rank's share) and the new statistics."""
  from corenet_tpu_torch.models.batch_renorm import BatchRenorm
  x, dout, variables, dtype, packing = (
      case[k] for k in ("x", "dout", "variables", "dtype", "packing"))
  c = variables["params"]["scale"].shape[0]
  layer = BatchRenorm(c, eps=1e-3, phase_packing=packing)
  layer.load_state_dict({
      "scale": torch.from_numpy(variables["params"]["scale"]),
      "bias": torch.from_numpy(variables["params"]["bias"]),
      "mean": torch.from_numpy(variables["batch_stats"]["mean"]),
      "var": torch.from_numpy(variables["batch_stats"]["var"]),
      "steps": torch.tensor(int(variables["batch_stats"]["steps"]),
                            dtype=torch.int32)})
  tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
  xt = _to_first(x[rank:rank + 1]).to(tdt).requires_grad_(True)
  y = layer.train()(xt)
  (y.float() * _to_first(dout[rank:rank + 1])).sum().backward()
  return {"y": _to_last(y), "x": _to_last(xt.grad),
          "scale": layer.scale.grad.numpy(), "bias": layer.bias.grad.numpy(),
          "mean": layer.mean.numpy(), "var": layer.var.numpy(),
          "steps": int(layer.steps)}


def layer_jobs(rank, world, renorm, semantic):
  """The cheap jobs of this file, in one group of ranks."""
  from corenet_tpu_torch.eval.qualitative import QualitativeResults
  from corenet_tpu_torch.eval.results import QuantitativeResults
  from corenet_tpu_torch.models import losses
  out = {"renorm": {name: _renorm_on_rank(rank, case)
                    for name, case in renorm.items()}}

  # The SEMANTIC loss on this rank's scene, and its logits' gradient.
  gt, logits = semantic
  lt = torch.from_numpy(logits[rank:rank + 1]).requires_grad_(True)
  loss = losses.xent_times_iou_agnostic(torch.from_numpy(gt[rank:rank + 1]),
                                        lt)
  loss.backward()
  out["semantic"] = (float(loss), lt.grad.numpy())

  q = QuantitativeResults(["__void__", "a"], "FG_BG")
  q.confusion += np.array([[1, 2], [3, 4]]) * (rank + 1)
  q.reduce_across_hosts()
  out["confusion"] = q.confusion

  class Writer:

    def __init__(self):
      self.images = []

    def add_image(self, tag, image, step):
      self.images.append((tag, int(image[0, 0, 0]), image.shape, step))

  writer = Writer() if rank == 0 else None
  qualitative = QualitativeResults("unused", 2, 4, writer, image_size=(4, 6))
  qualitative._summary_tiles = [np.full((20, 30, 3), 10 * rank + i, np.uint8)
                                for i in range(rank + 1)]
  qualitative.write_summaries(7)
  out["tiles"] = writer.images if writer else None

  # Unequal batches are refused on every rank.
  try:
    mesh.assert_equal_across_ranks(3 + rank, "the batch size")
    out["unequal"] = None
  except RuntimeError as e:
    out["unequal"] = str(e)
  mesh.assert_equal_across_ranks(3, "the batch size")
  return out


# ------------------------------------------------------------- the cases ----
def _renorm_cases():
  """Two scenes per case: (x, dout, variables) for float32 at steps 0,
  6000 and 45000 (past the ramp start the r and d clips engage), the same
  in bf16, and phase_packing 8 in both dtypes."""
  cases = {}
  for dtype in ("float32", "bfloat16"):
    for steps in (0, 6000, 45000):
      rng = np.random.default_rng(steps + 1)
      c = 7
      loc, spread = (8.0, 5.0) if steps == 45000 else (1.0, 2.0)
      x = rng.normal(loc, spread, (2, 3, 4, 5, c)).astype(np.float32)
      # The scenes differ: per-rank statistics would not be the global.
      x[1] = x[1] * 0.5 + 1.5
      cases[f"{dtype} steps {steps}"] = dict(
          x=x, dout=rng.standard_normal(x.shape).astype(np.float32),
          variables=_renorm_variables(rng, c, steps), dtype=dtype, packing=1)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, 3, 3, 40)) * 0.5 + 2.0).astype(
        np.float32)
    x[1] += 0.7
    cases[f"{dtype} packed"] = dict(
        x=x, dout=rng.standard_normal(x.shape).astype(np.float32),
        variables=_renorm_variables(rng, 5, 6000), dtype=dtype, packing=8)
  for case in cases.values():
    if case["dtype"] == "bfloat16":  # inputs exactly representable
      case["x"] = torch.from_numpy(case["x"]).bfloat16().float().numpy()
  return cases


def _renorm_variables(rng, c, steps):
  return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                     "bias": rng.normal(0, 0.3, c).astype(np.float32)},
          "batch_stats": {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                          "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
                          "steps": np.int32(steps)}}


def _semantic_case():
  """3 classes; scene 0 predicted well, scene 1 badly, so that the
  product of the global means (1 + iou)(1 + xent) lies far from the mean
  of the two scenes' products."""
  rng = np.random.default_rng(5)
  gt = rng.integers(0, 3, (2, 4, 5, 6)).astype(np.int32)
  logits = rng.normal(0, 1, (2, 4, 5, 6, 3)).astype(np.float32)
  logits[0] += 4.0 * np.eye(3, dtype=np.float32)[gt[0]]
  logits[1] -= 2.0 * np.eye(3, dtype=np.float32)[gt[1]]
  return gt, logits


RENORM_CASES = _renorm_cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  return run_ranks(tmp_path_factory.mktemp("layer_jobs"),
                   "test_torch_distributed", "layer_jobs",
                   {"renorm": RENORM_CASES, "semantic": _semantic_case()})


def _jax_renorm(case):
  """JAX's layer on both scenes in float32 and, for a bf16 case, in bf16:
  {dtype: (y, dx, dscale, dbias, mean, var)}."""
  import jax
  import jax.numpy as jnp
  from corenet_tpu.models.batch_renorm import BatchRenorm as JaxBatchRenorm
  layer = JaxBatchRenorm(eps=1e-3, phase_packing=case["packing"])
  variables = case["variables"]

  def objective(params, xx):
    y, updates = layer.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             xx, True, mutable=["batch_stats"])
    return ((y.astype(jnp.float32) * case["dout"]).sum(),
            (y, updates["batch_stats"]))

  out = {}
  dtypes = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
  for name in ("float32", case["dtype"]):
    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(
            variables["params"], jnp.asarray(case["x"], dtypes[name]))
    out[name] = {"y": y, "x": gx, "scale": gp["scale"], "bias": gp["bias"],
                 "mean": stats["mean"], "var": stats["var"],
                 "steps": int(stats["steps"])}
  return {k: {kk: (np.asarray(jnp.asarray(vv, jnp.float32))
                   if kk != "steps" else vv) for kk, vv in v.items()}
          for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(RENORM_CASES))
def test_batch_renorm_over_ranks_matches_jax_on_the_whole_batch(ranks, name):
  """Train mode on 2 ranks × 1 scene: each rank's output and input
  gradient are JAX's for its scene, the ranks' parameter gradients add up
  to JAX's, and every rank holds JAX's new running statistics. float32
  within 1e-5 relative; bf16 within twice JAX bf16's distance from JAX
  float32 (d), of both."""
  case = RENORM_CASES[name]
  ref = _jax_renorm(case)
  got = {key: np.concatenate([r["renorm"][name][key] for r in ranks])
         for key in ("y", "x")}
  got["scale"] = sum(r["renorm"][name]["scale"] for r in ranks)
  got["bias"] = sum(r["renorm"][name]["bias"] for r in ranks)
  for key in ("mean", "var"):
    tt.assert_array_equal(ranks[0]["renorm"][name][key],
                          ranks[1]["renorm"][name][key])
    got[key] = ranks[0]["renorm"][name][key]
  steps = int(case["variables"]["batch_stats"]["steps"]) + 1
  assert [r["renorm"][name]["steps"] for r in ranks] == [steps] * 2
  for key, value in got.items():
    want = ref[case["dtype"]][key]
    if case["dtype"] == "float32":
      tt.assert_allclose(value, want, rtol=1e-5,
                         atol=1e-5 * np.abs(want).max(), err_msg=key)
    else:
      f32 = ref["float32"][key]
      d = np.abs(want - f32).max() / np.abs(f32).max()
      assert 0 < d, key
      for other in (want, f32):
        err = np.abs(value - other).max() / np.abs(f32).max()
        assert err <= 2 * d, (key, err, d)


def test_the_semantic_loss_multiplies_global_means(ranks):
  """xent_times_iou_agnostic is a product of two batch means: over 2
  ranks it is the JAX loss of the whole batch (1e-5), not the mean of the
  ranks' products, from which it differs by far more than the tolerance;
  each rank's logits gradient is world_size times its share of JAX's
  (the ranks' gradients add up to world_size · dL/dθ)."""
  import jax
  from corenet_tpu.models import losses as jax_losses
  gt, logits = _semantic_case()
  want, grad = jax.value_and_grad(
      lambda lg: jax_losses.xent_times_iou_agnostic(gt, lg))(logits)
  per_scene = [float(jax_losses.xent_times_iou_agnostic(gt[i:i + 1],
                                                        logits[i:i + 1]))
               for i in range(2)]
  assert abs(np.mean(per_scene) - float(want)) > 1e-2 * float(want)
  for rank, result in enumerate(ranks):
    loss, dlogits = result["semantic"]
    tt.assert_allclose(loss, float(want), rtol=1e-5)
    tt.assert_allclose(dlogits / WORLD, np.asarray(grad)[rank:rank + 1],
                       rtol=1e-5, atol=1e-5 * np.abs(grad).max())


def test_confusion_and_tiles_reduce_across_ranks(ranks):
  """The confusion matrices add up on every rank (as the JAX package's
  two-process test has it); rank 0's writer gets the first 4 tiles of the
  ranks in rank order (1 from rank 0, 2 from rank 1); unequal batches
  are refused on every rank."""
  for result in ranks:
    tt.assert_array_equal(result["confusion"], [[3, 6], [9, 12]])
    assert result["confusion"].dtype == np.int64
    assert "the batch size differs between ranks" in result["unequal"]
  assert ranks[1]["tiles"] is None
  assert ranks[0]["tiles"] == [
      ("rec_0", 0, (20, 30, 3), 7), ("rec_1", 10, (20, 30, 3), 7),
      ("rec_2", 11, (20, 30, 3), 7)]


# ------------------------------------------------------- one process ----
def test_without_a_group_everything_is_one_process(monkeypatch):
  """No group: one rank, no reduction, no collective; a missing card and
  a missing torchrun environment raise instead of falling back."""
  assert not mesh.is_initialized()
  assert (mesh.process_count(), mesh.process_index()) == (1, 0)
  x = torch.arange(3.0)
  assert mesh.mean_over_ranks(x) is x
  count = _count("mesh.collectives")
  mesh.barrier("alone")
  mesh.assert_equal_across_ranks(5, "anything")
  assert mesh.host_all_gather(x)[0] is x
  assert _count("mesh.collectives") == count
  with pytest.raises(RuntimeError, match="no process group"):
    mesh.all_reduce_sum(x)
  assert mesh.local_device("cpu") == torch.device("cpu")
  monkeypatch.setenv("LOCAL_RANK", "3")
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
  with pytest.raises(RuntimeError, match="LOCAL_RANK 3 names cuda:3"):
    mesh.local_device("cuda")
  monkeypatch.delenv("RANK", raising=False)
  with pytest.raises(RuntimeError, match="RANK is not set"):
    mesh.initialize(device="cpu")
  assert not mesh.is_initialized()


def test_train_cli_refuses_the_space_axis(tmp_path):
  """--space=2 needs a world that 2 divides: one process without
  --multihost is refused before the configuration is read."""
  from corenet_tpu_torch.cli import train
  with pytest.raises(ValueError, match="does not divide the world size 1"):
    train.main(["--config_path=unused.json", "--space=2", "--device=cpu"])
  with pytest.raises(ValueError, match="does not divide the world size 1"):
    mesh.create_mesh(space=2)


# ------------------------------------------------------------ the launcher ----
def test_launch_success_no_retry():
  from corenet_tpu_torch.cli import launch
  assert launch.main(["--num_retries=2", "--retry_wait_sec=0.01", "--",
                      sys.executable, "-c", "pass"]) == 0


def test_launch_retries_until_success(tmp_path):
  """Whole-job retry: the first attempt fails, the relaunch succeeds."""
  from corenet_tpu_torch.cli import launch
  marker = tmp_path / "attempted"
  script = (f"import os, sys; p = {str(marker)!r}\n"
            "if os.path.exists(p): sys.exit(0)\n"
            "open(p, 'w').close(); sys.exit(3)\n")
  assert launch.main(["--num_retries=2", "--retry_wait_sec=0.01", "--",
                      sys.executable, "-c", script]) == 0
  assert marker.exists()


def test_launch_gives_up_after_retries():
  from corenet_tpu_torch.cli import launch
  assert launch.main(["--num_retries=1", "--retry_wait_sec=0.01", "--",
                      sys.executable, "-c", "import sys; sys.exit(7)"]) == 7


# --------------------------------------------------------------- ui.py ----
def test_ui_matches_jax(tmp_path, caplog):
  """The bar, the rank-tagged record format, Progress, and WorkerProgress's
  heartbeat files and rank-0 view, against the JAX package's."""
  from corenet_tpu.utils import ui as jax_ui
  from corenet_tpu_torch.utils import ui
  for fraction in (0.0, 0.05, 0.33, 0.5, 0.999, 1.0, 1.5):
    assert ui._bar(fraction) == jax_ui._bar(fraction)
  record = logging.LogRecord("x", logging.WARNING, "/a/b.py", 12, "m %d",
                             (3,), None)
  assert (ui._RankFormatter(2).format(record)
          == jax_ui._RankFormatter(2).format(record))
  assert list(ui.Progress(range(5), desc="t", interval_sec=0.0)) == list(
      range(5))

  logs = {}
  for name, module in (("port", ui), ("jax", jax_ui)):
    out = str(tmp_path / name)
    module.WorkerProgress(out, desc="train", interval_sec=0.0, rank=1,
                          num_ranks=3).report(50, 100, note="epoch 2")
    caplog.clear()
    with caplog.at_level(logging.INFO):
      module.WorkerProgress(out, desc="train", interval_sec=0.0, rank=0,
                            num_ranks=3).report(10, 100)
    logs[name] = caplog.records[-1].getMessage()
    assert sorted(os.listdir(os.path.join(out, "progress"))) == [
        "worker_0.json", "worker_1.json"]
  rates = re.compile(r"\(\d+\.\d+/s\)")  # the only clock-dependent part
  assert rates.sub("", logs["port"]) == rates.sub("", logs["jax"])
  assert "W2 |          | (no heartbeat)" in logs["port"]
  assert "50/100" in logs["port"] and "epoch 2" in logs["port"]


def test_ui_logs_each_rank_to_its_file(tmp_path):
  from corenet_tpu_torch.utils import ui
  root = logging.getLogger()
  saved = root.handlers[:], root.level
  try:
    ui.initialize_logging(str(tmp_path), rank=3)
    logging.getLogger("t").info("hello %d", 5)
    for handler in root.handlers:
      handler.flush()
  finally:
    for handler in root.handlers:
      handler.close()
    root.handlers[:], root.level = saved
  text = (tmp_path / "logs" / "worker_3.log").read_text()
  assert " W:3 test_torch_distributed.py:" in text and "hello 5" in text
