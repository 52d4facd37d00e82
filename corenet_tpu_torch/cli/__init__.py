"""Command-line entry points: train, eval, demo, the frozen-graph eval, the
retry launcher, the dataset and config tools, and the importers."""
