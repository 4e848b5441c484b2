"""The modes' window loops, one file a mode, found by the name a cell's
workload file gives."""
