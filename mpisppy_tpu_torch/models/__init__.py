# Scenario models of the port (numpy spec builders).
