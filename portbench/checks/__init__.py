"""The comparisons that decide ``correct``, one module per kind of output."""
