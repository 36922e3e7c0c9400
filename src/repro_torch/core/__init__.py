"""HiF4 format core, packed containers, policy and execution engine."""
