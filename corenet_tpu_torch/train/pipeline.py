"""Training pipeline: state creation or resume, the step loop, and the
checkpoint, summary, fill-audit and recurrent-eval cadences.

Counterpart of corenet_tpu/train/pipeline.py, one process per device.
`TrainPipeline` creates the state (a seeded CoreNet, optionally the
imported ResNet-50 encoder, a fresh Adam) and saves it, or resumes from
the newest `.cpt` under `<output_path>/cpt/`; each epoch's dataset is
re-derived from the global step, so a resumed run continues the JAX
package's data order (and, where the global batch does not divide the
dataset, goes on to the next epoch where the JAX package stops:
`_epoch_loader`); `run` steps until `max_steps`, writing temp and
persistent checkpoints, the loss to `<output_path>/tb/train/` and the
fill audit on their StepEvent schedules. `RecurrentEvals` runs the
configuration's evals at their schedules through one cached
`EvalPipeline` each, on an eval-mode twin over the training model's own
tensors, in the training dtype and, unless it is asked for the packed
decoder, with the fine one.

Under a process group (parallel/mesh.py; torchrun and the train CLI's
--multihost) the pipeline is the JAX package's multi-host one: the batch
size of the configuration is per process, and the global batch is that
times the process count; each rank steps on its contiguous shard of each
epoch; rank 0 creates and saves the first state and every rank then
reads it; rank 0 alone writes checkpoints and summaries; the raster
ground truth takes a static fill; rank 0 logs every worker's progress.
Every rank runs the recurrent evals, each on its shard of the eval set.

With a mesh of a 'space' axis (parallel/mesh.py::create_mesh(space=N),
the train CLI's --space) the ranks form data × space: the space ranks of
a data group load the same batches and train one depth slab each of a
depth-sharded model (models/decoder.py), the epoch is sharded over the
data groups, and the global batch is the configuration's batch times the
data count. Where the batch divides by the space count, the step shares
the device GT over the space ranks (train/gt.py::space_shared); on host
GT every space rank's producer thread voxelizes the whole batch. The
recurrent evals run the unsharded eval twin, each rank on its shard of
the eval set as above.

With `gt_mode="host"` the loader's producer thread voxelizes each batch
with the native C++ ops (data/batching.py::host_voxelize) while the step
runs, and the step trains on that `grid`.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import torch

from corenet_tpu_torch.config import config as cfg
from corenet_tpu_torch.config.config import config_to_dict
from corenet_tpu_torch.data.batching import (
    VOXELIZE_WINDOW_PIXELS, host_voxelize)
from corenet_tpu_torch.data.loader import DataLoader, distributed_indices
from corenet_tpu_torch.data.manager import DatasetManager
from corenet_tpu_torch.eval.pipeline import EvalPipeline
from corenet_tpu_torch.eval.super_resolution import (
    super_resolution_inference_factory)
from corenet_tpu_torch.models import batch_renorm
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.models.decoder import (
    packed_eligible, require_packed_eligible)
from corenet_tpu_torch.parallel import mesh as mesh_lib
from corenet_tpu_torch.train import checkpoint as cpt_lib
from corenet_tpu_torch.train import gt as gt_lib
from corenet_tpu_torch.train import state as state_lib
from corenet_tpu_torch.train.step import make_train_step
from corenet_tpu_torch.utils import fs, misc
from corenet_tpu_torch.utils.device import checked_device
from corenet_tpu_torch.utils.summary import SummaryWriter
from corenet_tpu_torch.utils.ui import WorkerProgress
from corenet_tpu_torch.voxel.fill import static_rounds_converged

log = logging.getLogger(__name__)

# Static interior-fill rounds that the JAX package uses under more than
# one process, where an adaptive fixpoint would desync the hosts. Real
# meshes converge in 2-3 rounds. The port takes it under more than one
# process too, so that its ground truth is the JAX package's (here each
# rank voxelizes alone, and no collective would desync); one process
# takes the adaptive fill unless the configuration asks for a static
# count.
FILL_ROUNDS_STATIC = 6

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def model_config_from_train_config(config: cfg.TrainConfig,
                                   num_classes: int) -> CoreNetConfig:
  """Output channels = num_classes for SEMANTIC, 2 for FG_BG; the decoder's
  resolution is the voxelization resolution reversed (the identity for the
  cubic grids used in practice, kept as the JAX package has it)."""
  vc = config.data.voxelization_config
  num_channels = {
      cfg.TaskType.SEMANTIC: num_classes,
      cfg.TaskType.FG_BG: 2,
  }[vc.task_type]
  return CoreNetConfig(decoder=DecoderConfig(
      resolution=vc.resolution.as_tuple()[::-1],
      num_output_channels=num_channels,
      last_upscale_factor=config.last_upscale_factor,
      latent_channels=config.latent_channels,
      skip_fraction=config.skip_fraction))


class TrainPipeline:

  def __init__(self, config: cfg.TrainConfig, output_path: str,
               mesh=None, extra_metadata: Optional[Dict[str, Any]] = None,
               gt_mode: str = "device", gt_algorithm: str = "raster",
               compute_dtype: str = "bfloat16",
               decoder_execution: str = "auto",
               phase_loss: Optional[bool] = None,
               renorm_ramp_start: Optional[int] = None, device="cuda"):
    """Arguments as the JAX package's TrainPipeline:

    gt_mode: 'device' voxelizes the ground truth in the step; 'host'
      voxelizes it with the native C++ ops in the loader's producer
      thread, overlapping the step (trades host CPU for device time).
    gt_algorithm: 'raster' (rasterize + fill) or 'parity'.
    compute_dtype: 'bfloat16' (the default; float32 parameters,
      statistics, logits and gradients) or 'float32'.
    decoder_execution: 'fine', 'packed' (the space-to-depth decoder,
      models/packing.py: the same parameters and checkpoints; needs
      last_upscale_factor 2 and an even seed grid) or 'auto' (packed
      where eligible, else fine, as the JAX package chooses; on the H100
      the packed h7 step takes 0.58× the fine step's device time in
      float32 and 0.69–0.73× in bf16: chip_smoke.py phase 12, PERF.md).
    phase_loss: the loss on phase-major logits; None = on for FG_BG with
      last_upscale_factor 2.
    renorm_ramp_start: the step at which BatchRenorm's r/d clips open
      (None keeps 5000).
    device: where the model trains; 'cuda' needs a card, and means this
      process's, cuda:LOCAL_RANK.
    mesh: the process group's (data, space) layout,
      `parallel.mesh.create_mesh(...)`'s result (the module docstring);
      None lays the group out as data only.
    """
    if mesh is None:
      mesh = mesh_lib.create_mesh()
    elif not isinstance(mesh, mesh_lib.Mesh):
      raise TypeError(f"mesh must be parallel.mesh.create_mesh()'s Mesh, "
                      f"got {type(mesh).__name__}")
    elif (mesh.data, mesh.space) != (mesh_lib.data_count(),
                                     mesh_lib.space_count()):
      raise ValueError(f"mesh {mesh} is not the layout that "
                       "parallel.mesh.create_mesh made last")
    if gt_mode not in ("device", "host"):
      raise ValueError(f"unknown gt_mode {gt_mode!r}")
    if gt_algorithm not in ("raster", "parity"):
      raise ValueError(f"unknown gt_algorithm {gt_algorithm!r}")
    if compute_dtype not in COMPUTE_DTYPES:
      raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    if decoder_execution not in ("auto", "fine", "packed"):
      raise ValueError(f"unknown decoder_execution {decoder_execution!r}")
    self.device = mesh_lib.local_device(checked_device(device))
    self.config = config
    self.output_path = output_path
    self.extra_metadata = extra_metadata or {}
    self.gt_mode = gt_mode
    self.gt_algorithm = gt_algorithm
    if renorm_ramp_start is not None:
      batch_renorm.set_ramp_start(renorm_ramp_start)
      log.info("BatchRenorm r/d ramps engage at step %d", renorm_ramp_start)

    vc = config.data.voxelization_config
    self.task_type = vc.task_type.value
    self.resolution = vc.resolution.as_tuple()
    self.dataset_manager = DatasetManager(config.data)
    self.classes = self.dataset_manager.classes
    self.model_config = model_config_from_train_config(
        config, len(self.classes))
    dec = self.model_config.decoder
    luf = dec.last_upscale_factor
    # The JAX pipeline's rule: an even seed grid, eligibility at stage 2.
    packed = (decoder_execution == "packed"
              or (decoder_execution == "auto"
                  and packed_eligible(dec.resolution, luf, 2)))
    if packed:
      require_packed_eligible(dec.resolution, luf, 2)
    phase_ok = self.task_type == "FG_BG" and luf == 2
    if phase_loss is None:
      phase_loss = phase_ok
    elif phase_loss and not phase_ok:
      raise ValueError("phase_loss requires FG_BG and last_upscale_factor=2")
    log.info("decoder execution: %s (decoder_execution=%r)",
             "packed" if packed else "fine", decoder_execution)
    self.model = CoreNet(self.model_config, phase_output=phase_loss,
                         compute_dtype=COMPUTE_DTYPES[compute_dtype],
                         packed_decoder=packed,
                         depth_shard=(mesh_lib.space_index(), mesh.space))
    if mesh.space > 1:
      log.info("space rank %d of %d: the decoder is sharded from tower %d",
               mesh_lib.space_index(), mesh.space,
               self.model.decoder.shard_stage)

    irm = vc.voxelization_image_resolution_multiplier
    # A static fill count when the configuration asks for one, or under
    # more than one process, as in the JAX package; the audit then checks
    # it. One process otherwise takes the exact adaptive fixpoint.
    self.fill_rounds = vc.voxelization_fill_rounds or None
    if (self.fill_rounds is None and mesh_lib.process_count() > 1
        and gt_algorithm == "raster"):
      self.fill_rounds = FILL_ROUNDS_STATIC
    if self.fill_rounds is not None and gt_algorithm == "raster":
      log.info("raster GT uses a static %d-round interior fill (config "
               "voxelization_fill_rounds, or the multi-process default); "
               "the fill audit runs every %d steps and once at the first "
               "step", self.fill_rounds, config.fill_audit_interval)
    self.voxelization_kwargs = dict(
        sub_grid_sampling=vc.sub_grid_sampling,
        image_resolution_multiplier=irm,
        conservative_rasterization=vc.conservative_rasterization,
        projection_depth_multiplier=(
            vc.voxelization_projection_depth_multiplier),
        max_bbox_pixels=VOXELIZE_WINDOW_PIXELS,
        fill_rounds=self.fill_rounds,
        num_label_values=len(self.classes))
    # Subdivision target: a triangle's bbox is bounded by its longest edge,
    # and the rasterizer's window must cover bbox·irm plus ~4 px of margin.
    self.max_edge_view = (VOXELIZE_WINDOW_PIXELS - 4) / irm / max(
        self.resolution)
    self._last_batch = None
    self._fill_audit_count = 0
    self.cpt_manager = cpt_lib.CheckpointManager(fs.join(output_path, "cpt"))
    self.rank0 = mesh_lib.process_index() == 0
    self.tb_writer = (SummaryWriter(fs.join(output_path, "tb", "train"))
                      if self.rank0 else None)
    self.state: Optional[state_lib.TrainState] = None
    self.train_step = None

  # ------------------------------------------------------------ state ----
  def create_or_load_state(self) -> state_lib.TrainState:
    """The newest checkpoint's state; without one, a fresh state (weights
    from seed 0, the imported encoder if configured, step 0), saved
    first. Under more than one process rank 0 saves the fresh state, and
    after a barrier every rank reads the newest checkpoint."""
    if self.state is None:
      self.model.reset_parameters(torch.Generator().manual_seed(0))
      self._load_encoder_weights()
      self.state = state_lib.create_train_state(
          self.model, self.config.initial_learning_rate,
          self.config.adam_epsilon, device=self.device)
      self.train_step = make_train_step(
          self.model, self.state.optimizer, self.task_type, self.resolution,
          voxelization_kwargs=dict(self.voxelization_kwargs,
                                   algorithm=self.gt_algorithm))
    single = mesh_lib.process_count() == 1
    if self.rank0 and not self.cpt_manager.list_checkpoints():
      log.info("No checkpoint found; creating initial state")
      self.cpt_manager.save_state(self.state, self._extra_metadata())
      if single:
        return self.state
    mesh_lib.barrier("initial-checkpoint")
    state, _, path = self.cpt_manager.read_last_checkpoint(self.state)
    self.state = state
    log.info("Loaded checkpoint %s (step %d)", path, state.global_step)
    return self.state

  def _extra_metadata(self) -> Dict[str, Any]:
    meta = dict(self.extra_metadata)
    meta.setdefault("train_config", config_to_dict(self.config))
    meta.setdefault("classes", list(self.classes))
    return meta

  def _load_encoder_weights(self) -> None:
    """The imported ResNet-50 ImageNet weights into the encoder: an `.npz`
    of cli/import_resnet50_checkpoint.py's layout; an empty path keeps the
    fresh encoder."""
    path = self.config.resnet50_imagenet_checkpoint
    if not path:
      return
    from corenet_tpu_torch.cli.import_resnet50_checkpoint import (
        load_encoder_variables)
    self.model.load_state_dict(
        load_encoder_variables(self.model.state_dict(), path))

  # ------------------------------------------------------------- loop ----
  def _epoch_loader(self, start_step: int) -> DataLoader:
    """This rank's batches from global step `start_step` to the end of
    its epoch (its data group's: every space rank of a group takes the
    same batches).

    An epoch is the examples that full global batches cover: the
    dataset's length rounded down to a multiple of the global batch, so
    (epoch, offset) = divmod(start_step, covered). Each rank takes its
    contiguous, wrap-padded shard of the epoch's dataset, as the JAX
    pipeline shards it (`distributed_indices`), skips the batches the
    epoch's first offset / global_batch steps took, and ends where the
    epoch does. From an epoch's start these are the JAX pipeline's
    batches, all of them where the global batch divides the length, and
    with one process its batches from any step. Where the global batch
    does not divide the length the JAX pipeline derives the epoch from
    the whole length, and the step that ends the first epoch finds fewer
    examples than a batch left (it raises "Empty training dataset"):
    here the next epoch starts there instead. Under more than one
    process the JAX pipeline resumes mid-epoch by sharding the epoch's
    remaining examples anew, which repeats some and skips others: here a
    resumed rank goes on with its own shard's next batch, the batch an
    uninterrupted run takes."""
    dl_cfg = self.config.data.data_loader
    # The configuration's batch size is per data group, the process of the
    # reference's convention (the space ranks of a group load the same
    # batches); the global step advances by the global batch.
    batch, world = dl_cfg.batch_size, mesh_lib.data_count()
    global_batch = batch * world
    covered = (self.dataset_manager.epoch_len // global_batch
               * global_batch)
    if covered == 0:
      raise RuntimeError(f"the training dataset holds "
                         f"{self.dataset_manager.epoch_len} examples, fewer "
                         f"than a global batch of {global_batch}")
    epoch, offset = divmod(start_step, covered)
    dataset = self.dataset_manager.create_dataset(local_seed=epoch)
    indices = distributed_indices(len(dataset), world,
                                  mesh_lib.data_index(), pad_data=True,
                                  shuffle=False)
    shard = dataset.select(
        indices[offset // global_batch * batch:covered // world])
    return DataLoader(
        shard, batch_size=dl_cfg.batch_size,
        num_workers=dl_cfg.num_data_workers,
        prefetch_factor=dl_cfg.prefetch_factor,
        max_edge_view=self.max_edge_view,
        random_grid_offset=self.config.random_grid_offset,
        seed=start_step, drop_last=True,
        batch_transform=(self.host_ground_truth if self.gt_mode == "host"
                         else None),
        worker_processes=None if dl_cfg.worker_processes else False)

  def host_ground_truth(self, hb) -> Dict[str, Any]:
    """The `grid` and `v2x` of a host batch, voxelized on the host as the
    configuration's `voxelization_config` asks (the loader's
    `batch_transform` under gt_mode='host')."""
    vc = self.config.data.voxelization_config
    grid, v2x = host_voxelize(
        hb, self.task_type, self.resolution,
        image_resolution_multiplier=(
            vc.voxelization_image_resolution_multiplier),
        conservative_rasterization=vc.conservative_rasterization,
        projection_depth_multiplier=(
            vc.voxelization_projection_depth_multiplier),
        sub_grid_sampling=vc.sub_grid_sampling)
    return {"grid": grid, "v2x": v2x}

  def train_steps(self):
    """Infinite generator of (global_step, metrics). Each epoch's dataset
    is re-created from the current global step, so a resumed run continues
    where the saved one was."""
    if self.state is None:
      raise RuntimeError("call create_or_load_state() first")
    while True:
      loader = self._epoch_loader(self.state.global_step)
      got_batch = False
      for hb, _ in loader:
        got_batch = True
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in hb.step_inputs(self.task_type).items()}
        self._last_batch = batch
        self.state, metrics = self.train_step(self.state, batch)
        yield self.state.global_step, metrics
      if not got_batch:
        raise RuntimeError("Empty training dataset")

  def audit_static_fill(self) -> Optional[bool]:
    """Whether the static interior fill reaches the exact fixpoint on one
    scene of the last batch (rotating through its scenes from audit to
    audit): the scene is voxelized without fill, and one round beyond the
    static count must change nothing. False is logged as an error (that
    scene's ground truth is under-filled). None when there is nothing to
    audit: adaptive fill, the parity GT, the host GT (whose C++ flood
    fill is exact), or no batch yet."""
    if (self.fill_rounds is None or self.gt_algorithm != "raster"
        or self.gt_mode != "device"):
      return None
    batch = self._last_batch
    if batch is None:
      return None
    i = self._fill_audit_count % int(batch["grid_offset"].shape[0])
    self._fill_audit_count += 1
    kwargs = dict(self.voxelization_kwargs, fill_inside=False,
                  resolution=self.resolution)
    del kwargs["fill_rounds"]
    grid, _ = gt_lib.voxelize_batch(
        *(batch[k][i:i + 1] for k in ("triangles", "tri_mesh_slot",
                                      "tri_valid", "mesh_labels",
                                      "grid_offset")), **kwargs)
    ok = bool(static_rounds_converged(grid, self.fill_rounds))
    if not ok:
      log.error(
          "GT INTERIOR-FILL UNDER-FILL DETECTED: the static %d-round fill "
          "did not reach the exact fixpoint on an audited sample; a cavity "
          "in this dataset winds more than %d turns and its GT is corrupt "
          "(outside voxels labeled interior). Raise voxelization_fill_rounds "
          "in the config.", self.fill_rounds, self.fill_rounds)
    return ok

  def run(self, recurrent_evals: Optional["RecurrentEvals"] = None,
          max_steps: Optional[int] = None,
          profile_dir: Optional[str] = None,
          profile_start: int = 20, profile_steps: int = 10):
    """The training loop with its cadences. Stops once the global step
    reaches `max_steps` (default: the config's; negative = never), with a
    persistent checkpoint.

    profile_dir: when set, `profile_steps` iterations from iteration
    `profile_start` run under torch.profiler, whose trace is written to
    `<profile_dir>/trace.json` (Chrome trace format)."""
    self.create_or_load_state()
    config = self.config
    ev_temp = misc.StepEvent(0, config.checkpoint_interval)
    ev_persistent = misc.StepEvent(0, config.persistent_checkpoint_interval)
    ev_tb = misc.StepEvent(0, config.tensorboard_log_interval)
    # The fill audit on its own cadence, and once at the first step.
    ev_fill = misc.StepEvent(0, config.fill_audit_interval)
    fill_audited_once = False
    limit = max_steps if max_steps is not None else config.max_steps
    profiler = _StepProfiler(profile_dir, profile_start, profile_steps,
                             self.device)
    # Rank 0's view of every worker's step.
    worker_progress = (WorkerProgress(self.output_path, desc="train",
                                      interval_sec=60.0)
                       if mesh_lib.process_count() > 1 else None)

    prev_step = self.state.global_step
    try:
      for step, metrics in self.train_steps():
        profiler.tick()
        if ev_tb.trigger(prev_step, step) and self.tb_writer is not None:
          loss = float(metrics["loss"])
          self.tb_writer.add_scalar("loss", loss, step)
          self.tb_writer.flush()
          log.info("step %d loss %.5f", step, loss)
        if worker_progress is not None:
          worker_progress.report(step, limit if limit >= 0 else None)

        if self.rank0:
          if ev_persistent.trigger(prev_step, step):
            self.cpt_manager.save_state(self.state, self._extra_metadata(),
                                        persistent=True)
          elif ev_temp.trigger(prev_step, step):
            self.cpt_manager.save_state(self.state, self._extra_metadata())

        if (self.fill_rounds is not None
            and (not fill_audited_once or ev_fill.trigger(prev_step, step))):
          ok = self.audit_static_fill()
          fill_audited_once = fill_audited_once or ok is not None
          if ok is not None and self.tb_writer is not None:
            self.tb_writer.add_scalar("gt/fill_audit_ok", float(ok), step)

        if recurrent_evals is not None:
          recurrent_evals.run(self, prev_step, step)

        prev_step = step
        if 0 <= limit <= step:
          if self.rank0:
            self.cpt_manager.save_state(self.state, self._extra_metadata(),
                                        persistent=True)
          log.info("Reached max_steps=%d; stopping", limit)
          return
    finally:
      profiler.close()
      if self.tb_writer is not None:
        self.tb_writer.flush()


class _StepProfiler:
  """torch.profiler over a window of loop iterations (a no-op without a
  directory)."""

  def __init__(self, profile_dir, start, steps, device):
    self.profile_dir = profile_dir
    self.start, self.steps, self.device = start, steps, device
    self.iteration = 0
    self.profile = None

  def _sync(self):
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)

  def tick(self):
    if self.profile_dir is None:
      return
    if self.iteration == self.start:
      from torch.profiler import ProfilerActivity, profile
      activities = [ProfilerActivity.CPU]
      if self.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
      self._sync()
      self.profile = profile(activities=activities)
      self.profile.start()
      log.info("profiler: tracing %d steps to %s", self.steps,
               self.profile_dir)
    elif (self.profile is not None
          and self.iteration == self.start + self.steps):
      self.close()
    self.iteration += 1

  def close(self):
    if self.profile is None:
      return
    self._sync()
    self.profile.stop()
    fs.makedirs(self.profile_dir)
    path = fs.join(self.profile_dir, "trace.json")
    self.profile.export_chrome_trace(path)
    self.profile = None
    log.info("profiler: trace written to %s", path)


class RecurrentEvals:
  """Scheduled evals during training. One EvalPipeline per eval, cached
  across runs, with its summary writer at `<output_path>/tb/<name>/`; the
  inference factory is made once and applied to the training model's
  current tensors at each run. The evals decode with the fine decoder
  unless `packed_execution` asks for the packed one, whichever the
  training model runs: the JAX package's recurrent evals take its
  serving default (packed), whose logits move within the packed
  envelope."""

  def __init__(self, evals: List[cfg.RecurrentEvalConfig], output_path: str,
               packed_execution: bool = False):
    self.configs = evals
    self.output_path = output_path
    self.packed_execution = packed_execution
    self.events = [
        misc.StepEvent(e.start_step, e.interval) if e.start_step >= 0 else None
        for e in evals
    ]
    self._pipelines = {}
    self._inference_factory = None

  def run(self, pipeline: TrainPipeline, prev_step: int, next_step: int,
          force: bool = False):
    for event, rec in zip(self.events, self.configs):
      if not force and (event is None or
                        not event.trigger(prev_step, next_step)):
        continue
      if rec.persistent_checkpoint and pipeline.rank0:
        pipeline.cpt_manager.save_state(
            pipeline.state, pipeline._extra_metadata(), persistent=True)
      self.run_single(pipeline, rec.config, next_step)

  def run_single(self, pipeline: TrainPipeline, eval_config: cfg.EvalConfig,
                 step: int) -> Optional[float]:
    if self._inference_factory is None:
      self._inference_factory = super_resolution_inference_factory(
          pipeline.model, pipeline.model_config.decoder.resolution,
          packed_execution=self.packed_execution, device=pipeline.device)
    # The state dict's tensors are the model's own (no copy): the eval
    # reads the weights as they are now, and never writes them.
    inference = self._inference_factory(pipeline.state.model.state_dict())

    if eval_config.name not in self._pipelines:
      writer = (SummaryWriter(fs.join(pipeline.output_path, "tb",
                                      eval_config.name))
                if pipeline.rank0 else None)
      self._pipelines[eval_config.name] = EvalPipeline(
          eval_config, fs.join(pipeline.output_path, "evals"), inference,
          summary_writer=writer, device=pipeline.device)
    ep = self._pipelines[eval_config.name]
    ep.inference_fn = inference
    miou = ep.run_eval(step)
    if miou is not None and pipeline.tb_writer is not None:
      pipeline.tb_writer.add_scalar(f"eval/{eval_config.name}/mIoU", miou,
                                    step)
      pipeline.tb_writer.flush()
    return miou
