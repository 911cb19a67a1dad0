"""The benchmark's general code: cells, seeded inputs, drivers, timing, trace and judging."""
