"""Options, stats, profiling counters and test fixtures."""
