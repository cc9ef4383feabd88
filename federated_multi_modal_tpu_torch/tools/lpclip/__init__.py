"""The linear-probe tools of the port."""
