# Hub and spoke cylinders of the port.
