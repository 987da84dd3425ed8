# Algorithms of the port: PH, Lagrangian bounds, x-hat evaluation and
# the fused hub-and-spoke wheel step.
