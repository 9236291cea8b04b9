"""Seconds from the process's start to the window: importing torch and
the port, the CUDA context, the kernel library (built in a checkout's
first run), the inputs made on the device and the warm-up requests;
without the seconds the reference spent making a cell's inputs."""


def read(run):
    return run.setup_s
