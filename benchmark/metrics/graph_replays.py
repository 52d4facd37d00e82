"""The share of the traced window's requests that replayed the serving
product's CUDA graph, in percent: the main-thread `serve.request` spans
inside the trace whose counts hold `serve.graph.replays`. A program that
counts none of the `serve.graph.*` counters gives no value. Reads
`graph_replays.serve`."""

from benchmark.harness import spans

COUNTERS = ("serve.graph.eager", "serve.graph.captures",
            "serve.graph.replays")


def read(run):
  requests = [s.counts or {}
              for s in spans.main_thread(spans.program_spans(run.trace))
              if s.name == "serve.request"]
  if not any(name in counts for counts in requests for name in COUNTERS):
    return None
  replayed = sum("serve.graph.replays" in counts for counts in requests)
  return 100.0 * replayed / len(requests)
