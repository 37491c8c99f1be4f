"""The plain reference that decides ``correct``: the port's plain paths as a
frozen copy in plain PyTorch (fp32; ``"float8"`` for the control), with its
own planner and routing. It imports nothing of the port."""
