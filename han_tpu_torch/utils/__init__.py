"""Small utilities of the port: device selection and profiling."""
