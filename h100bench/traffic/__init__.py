"""Traffic drivers, named by a workload's ``driver``; each reads its
parameters from the workload file."""
