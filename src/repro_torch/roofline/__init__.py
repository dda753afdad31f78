from .analysis import (RooflineReport, analyze_counts, bound, collective_bytes,  # noqa: F401
                       count_program, roofline_terms, save_report)
