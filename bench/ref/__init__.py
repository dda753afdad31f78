"""The plain reference the benchmark judges served answers against."""
