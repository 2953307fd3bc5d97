"""Hardware model of the paper's testbed (planner input)."""
