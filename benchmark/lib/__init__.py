"""The benchmark's frozen yardstick: cells, frames, counts, peaks, traces."""
