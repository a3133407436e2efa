"""Training of the port: state, outer step, schedules, epoch loop."""
