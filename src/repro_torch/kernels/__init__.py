"""The BCSR SpMM kernel, its plain version and the op that dispatches to them."""
