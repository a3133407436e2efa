"""Data parallelism: process groups, the cross-rank means, the launcher of
ranks and the data-parallel dry run."""
