"""The port's eval metrics and results (corenet_tpu_torch/eval/metrics.py,
eval/results.py) against the JAX package's, on the CPU: integer counts and
float64 math on the same inputs, so everything is equal exactly, and the
CSV text (written without pandas) equals the text pandas writes there.
"""

import math

import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.eval import metrics as jax_metrics
from corenet_tpu.eval import results as jax_results
from corenet_tpu_torch.eval import metrics, results

CLASSES = ["__void__", "bench", "car", "chair", "lamp"]


def _labels(seed, shape=(3, 6, 7, 8), num_classes=5, absent=(3,)):
  """Random GT and predictions over the classes but the absent ones."""
  rng = np.random.default_rng(seed)
  present = [c for c in range(num_classes) if c not in absent]
  gt = rng.choice(present, shape).astype(np.int32)
  pred = rng.choice(present, shape).astype(np.int32)
  return pred, gt


def test_confusion_matrix_matches_jax_and_rejects_foreign_labels():
  pred, gt = _labels(0)
  want = np.asarray(jax_metrics.confusion_matrix(jnp.asarray(pred),
                                                 jnp.asarray(gt), 5))
  got = metrics.confusion_matrix(torch.from_numpy(pred),
                                 torch.from_numpy(gt), 5)
  assert got.dtype == torch.int64 and got.shape == (5, 5)
  tt.assert_array_equal(got.numpy(), want)
  assert got.sum() == pred.size and got[3].sum() == 0 == got[:, 3].sum()
  # uint8 grids count the same.
  tt.assert_array_equal(
      metrics.confusion_matrix(torch.from_numpy(pred),
                               torch.from_numpy(gt.astype(np.uint8)),
                               5).numpy(), want)
  with pytest.raises(ValueError, match="outside"):
    metrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt), 4)
  # A prediction outside the classes beside a small GT label (gt·C + pred
  # would land in another cell), and negative labels, raise too.
  for bad_pred, bad_gt in (([0, 5], [0, 0]), ([0, -1], [0, 1]),
                           ([0, 1], [-1, 1])):
    with pytest.raises(ValueError, match="outside"):
      metrics.confusion_matrix(torch.tensor(bad_pred), torch.tensor(bad_gt),
                               5)


def test_tfpn_and_metrics_match_jax_with_nan_for_absent_classes():
  pred, gt = _labels(1)
  matrix = metrics.confusion_matrix(torch.from_numpy(pred),
                                    torch.from_numpy(gt), 5).numpy()
  for name in ("compute_tfpn", "compute_tfpn_fg"):
    want = getattr(jax_metrics, name)(matrix)
    got = getattr(metrics, name)(matrix)
    for field in ("tp", "tn", "fp", "fn"):
      tt.assert_array_equal(getattr(got, field), getattr(want, field))
    m_want = jax_metrics.compute_voxel_metrics(want)
    m_got = metrics.compute_voxel_metrics(got)
    for field in ("iou", "precision", "recall"):
      tt.assert_array_equal(getattr(m_got, field), getattr(m_want, field))
  per_class = metrics.compute_voxel_metrics(metrics.compute_tfpn(matrix))
  assert np.isnan(per_class.iou[3]) and not np.isnan(per_class.iou[:3]).any()
  tfpn = metrics.compute_tfpn(matrix)
  tt.assert_array_equal(tfpn.tp + tfpn.tn + tfpn.fp + tfpn.fn,
                        np.full(5, pred.size, np.float64))


@pytest.mark.parametrize("task_type", ["FG_BG", "SEMANTIC"])
@pytest.mark.parametrize("grid_dtype", [np.int32, np.uint8])
def test_extract_labels_matches_jax(task_type, grid_dtype):
  rng = np.random.default_rng(2)
  channels = 2 if task_type == "FG_BG" else 5
  pmf = rng.random((3, 4, 5, 6, channels)).astype(np.float32)
  pmf[0, 0, 0, :3] = 0.25  # exact ties: the first maximum wins
  gt = rng.integers(0, channels, (3, 4, 5, 6)).astype(grid_dtype)
  fg = np.array([4, 300, 2], np.int32)  # 300: beyond a byte
  want_pred, want_gt = jax_results.extract_labels(
      jnp.asarray(pmf), jnp.asarray(gt.astype(np.int32)), jnp.asarray(fg),
      task_type)
  got_pred, got_gt = results.extract_labels(
      torch.from_numpy(pmf), torch.from_numpy(gt), torch.from_numpy(fg),
      task_type)
  assert got_pred.dtype == got_gt.dtype == torch.int32
  tt.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
  tt.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
  assert (got_pred[0, 0, 0, :3] == 0).all()
  if task_type == "FG_BG":
    assert set(np.unique(got_gt[1].numpy())) == {0, 300}


def _both_results(task_type, batches):
  """The same batches through both packages' QuantitativeResults."""
  want = jax_results.QuantitativeResults(CLASSES, task_type)
  got = results.QuantitativeResults(CLASSES, task_type)
  for pmf, gt, fg, valid in batches:
    want.add_batch(jnp.asarray(pmf), jnp.asarray(gt), fg, valid)
    got.add_batch(torch.from_numpy(pmf), torch.from_numpy(gt), fg, valid)
  return want, got


def _batches(task_type, seed=3):
  rng = np.random.default_rng(seed)
  channels = 2 if task_type == "FG_BG" else 5
  out = []
  for valid in (None, np.array([True, True, True]),
                np.array([True, False, True])):
    pmf = rng.random((3, 4, 5, 6, channels)).astype(np.float32)
    gt = rng.integers(0, channels - (task_type == "SEMANTIC"),
                      (3, 4, 5, 6)).astype(np.int32)
    if task_type == "SEMANTIC":
      pmf[..., 4] = 0  # class 4 is never predicted nor present
    out.append((pmf, gt, np.array([1, 2, 1], np.int32), valid))
  return out


@pytest.mark.parametrize("task_type", ["FG_BG", "SEMANTIC"])
def test_quantitative_results_match_jax_down_to_the_csv(task_type, tmp_path):
  want, got = _both_results(task_type, _batches(task_type))
  tt.assert_array_equal(got.confusion, want.confusion)
  assert got.confusion.dtype == np.int64
  # The padded scene of the third batch is not counted.
  assert got.confusion.sum() == (3 + 3 + 2) * 4 * 5 * 6
  frame = want.compute_metrics()
  table = got.compute_metrics()
  assert list(table.columns) == list(frame.columns)
  tt.assert_array_equal(table.values, frame.to_numpy().astype(np.float64))
  assert np.isnan(table.values).any()  # the absent classes
  assert got.get_mean_iou() == want.get_mean_iou()
  assert not math.isnan(got.get_mean_iou())
  summaries, jax_summaries = got.scalar_summaries(), want.scalar_summaries()
  assert list(summaries) == list(jax_summaries)
  for key, value in summaries.items():
    tt.assert_array_equal(value, jax_summaries[key], err_msg=key)
  assert summaries["General/mIoU"] == got.get_mean_iou()

  want.write_csv(str(tmp_path / "jax" / "voxel_metrics.csv"))
  got.write_csv(str(tmp_path / "port" / "deeper" / "voxel_metrics.csv"))
  text = (tmp_path / "port" / "deeper" / "voxel_metrics.csv").read_text()
  assert text == (tmp_path / "jax" / "voxel_metrics.csv").read_text()
  assert text.startswith(",__void__,bench,car,chair,lamp,__global__\niou,")
  assert ",," in text or ",\n" in text  # NaN is an empty field


def test_csv_text_equals_pandas_on_awkward_numbers():
  import pandas
  values = np.array([[1.0, 0.1, 1e-05, math.nan, 1 / 3, 0.5],
                     [1e16, 123456789.123456789, 5e-324, 0.0, 2 / 3, 1.0],
                     [math.nan, 0.30000000000000004, 1e22, 1e-7, 100.0,
                      0.25]])
  columns = ("__void__", "with,comma", 'with"quote', "c", "d", "__global__")
  table = results.VoxelMetricsTable(columns, values)
  frame = pandas.DataFrame(values, index=list(results.METRIC_NAMES),
                           columns=list(columns))
  assert table.to_csv() == frame.to_csv()
  column = table.column("c")
  assert math.isnan(column["iou"]) and column["recall"] == 1e-7
  tt.assert_array_equal(table.row("recall"), values[2])


def test_mean_iou_skips_absent_classes_and_the_table_needs_void_first():
  confusion = np.zeros((4, 4), np.int64)
  confusion[0, 0], confusion[1, 1], confusion[1, 0] = 50, 30, 10
  confusion[2, 2], confusion[0, 2] = 5, 15  # class 3 is absent
  table = results.compute_voxel_metrics_table(confusion, CLASSES[:4])
  tt.assert_allclose(table.row("iou"), [50 / 75, 30 / 40, 5 / 20, math.nan,
                                        (30 + 5) / (30 + 5 + 10 + 15)])
  acc = results.QuantitativeResults(CLASSES[:4], "SEMANTIC")
  with pytest.raises(RuntimeError, match="compute_metrics"):
    acc.get_mean_iou()
  acc.confusion += confusion
  acc.compute_metrics()
  assert acc.get_mean_iou() == pytest.approx((0.75 + 0.25) / 2)
  empty = results.QuantitativeResults(CLASSES[:4], "SEMANTIC")
  empty.compute_metrics()
  assert math.isnan(empty.get_mean_iou())
  bad = results.QuantitativeResults(["car", "__void__"], "SEMANTIC")
  bad.compute_metrics()
  with pytest.raises(ValueError, match="__void__"):
    bad.get_mean_iou()
