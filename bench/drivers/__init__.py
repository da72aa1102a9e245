"""One module per entry point a window drives; a cell's workload file
names its driver."""
