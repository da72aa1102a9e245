"""The BCSR SpMM and SDDMM kernels, their plain versions and the ops that
dispatch to them."""
