"""The benchmark's own inputs: a vectorised LDBC-SNB-style generator and the Q1-Q8 query builders."""
