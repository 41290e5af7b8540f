"""The harness: finding a cell's files, its inputs, the comparison that
decides ``correct``, and the reduction of a profiler trace."""
