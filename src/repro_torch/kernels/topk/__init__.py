"""topk kernel family: gather / scatter of kept values over client rows."""
