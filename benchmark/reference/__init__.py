"""The plain reference the benchmark checks the program against."""
