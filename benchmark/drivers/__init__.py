"""One driver per entry point of the program: ``run(run)`` builds the
system from the cell's configuration and traffic, warms up the cell's own
shapes, measures the window, reads the peak, frees the program's state,
then compares the window's outputs with the plain reference."""
