"""The benchmark's own machinery: the manifest and the files it names, the
weights drawn from a seed, the profiler's reading, the yardstick's counts
and peaks, the comparison that decides ``correct`` and the result line."""
